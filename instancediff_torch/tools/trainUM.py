"""Train the drift or DDPM engine (port of the repository's ``trainUM.py``).

    python -m instancediff_torch.tools.trainUM -opt=Configurations/tiny_cpu.yml --platform cpu

The flags are ``trainUM.py``'s. ``--platform`` picks the device: the default
is CUDA, ``cpu`` runs the plain PyTorch path. The port trains on one card:
``train.dist: true`` and ``--multihost`` raise. As in JAX: the experiment
under ``path.root/experiments/<name>`` (archived when it exists and this is
not a resume), the config's files stored beside it, a ``./log`` link to it;
the train loader in ``DistIterSampler``'s epoch-seeded order, the last short
batch dropped; one ``optimize_parameters`` per batch at the epoch's cosine
learning rate; the loss message every ``logger.print_freq`` iterations, the
bundle and ``{iter}.state`` every ``logger.save_checkpoint_freq`` and at
every fifth epoch's end, the bundle ``latest`` at the end; inline
validation every ``train.val_freq`` iterations through ``engine.test`` (on
CUDA the compiled sampler) over at most 10 validation batches, their PSNR,
SSIM and RMSE logged and ``LQ|pred|GT`` written as raw float32. SIGTERM or
SIGINT finishes the step, saves the bundle and the state, and returns.

Each iteration's randomness comes from a ``torch.Generator`` on the device
seeded from ``(train.manual_seed, iteration)`` (JAX folds the iteration into
its root key), and validation batch ``i``'s from ``(manual_seed, iteration,
i)``, so a resumed run draws what the uninterrupted run drew. A resume
(``path.resume_state``) restores the optimizers, the step and the EMA from
the state file, the weights from the bundle of its iteration (``check_resume``;
the rolling EMA files skipped when the state carried the EMA) and re-enters
at the next epoch. ``main`` returns the engine."""

from __future__ import annotations

import argparse
import os
import os.path as osp
import signal
import time

import numpy as np
import torch

from .. import data as data_pkg
from ..config import check_resume, dict2str, dict_to_nonedict, parse
from ..models import create_model
from ..sde import create_sde
from ..utils.file_utils import (mkdir_and_rename, mkdirs, set_random_seed, setup_logger,
                                store_files)
from ..utils.img_utils import save_raw
from ..utils.metrics import eval_restoration

MAX_VAL = 10  # the reference caps inline validation at 10 batches


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` (the
    counterpart of ``jax.random.fold_in``)."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="accepted for the reference's CLI; the port trains on one card")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--platform", type=str, default=None,
                        help="cpu: the plain PyTorch path (default: cuda)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training: not ported (one card)")
    args = parser.parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: the port trains on one card")
    device = "cuda" if args.platform in (None, "cuda", "gpu") else args.platform

    opt = dict_to_nonedict(parse(args.opt, is_train=True))
    train_opt = opt["train"]
    if train_opt.get("dist"):
        raise NotImplementedError(
            "train.dist: data parallelism over several cards is not ported; the port "
            "trains on one card (ROADMAP queue 1: DDP, tested with gloo on the CPU)")
    seed = train_opt.get("manual_seed") or 0
    set_random_seed(seed)

    resume_state_path = opt["path"].get("resume_state")
    if not resume_state_path:
        mkdir_and_rename(opt["path"]["experiments_root"])
    mkdirs([opt["path"]["models"], opt["path"]["training_state"], opt["path"]["val_images"]])
    store_files(opt, osp.join(opt["path"]["experiments_root"], "files"))
    try:
        if osp.islink("./log") or osp.exists("./log"):
            os.remove("./log")
        os.symlink(opt["path"]["experiments_root"], "./log")
    except OSError:
        pass
    mkdirs([opt["path"]["log"]])
    logger = setup_logger("instancediff_torch", opt["path"]["log"], "train", screen=True,
                          tofile=True)
    logger.info(dict2str(opt))

    train_loader = val_loader = None
    any_gt_only = False
    for phase, dataset_opt in opt["datasets"].items():
        phase = phase.split("_")[0]
        dataset = data_pkg.create_dataset(dataset_opt)
        any_gt_only = any_gt_only or bool(getattr(dataset, "gt_only", False))
        if phase == "train":
            train_loader = data_pkg.create_dataloader(
                dataset, dataset_opt, data_pkg.DistIterSampler(len(dataset)))
            logger.info("train dataset: %d images, %d iters/epoch", len(dataset),
                        len(train_loader))
        elif phase == "val":
            val_loader = data_pkg.create_dataloader(dataset, dataset_opt)
            logger.info("val dataset: %d images", len(dataset))
    if train_loader is None:
        raise ValueError("no datasets.train entry in the config")

    which_model = train_opt["which_model"]
    model_opt = opt["models"][which_model]
    model = create_model(train_opt, model_opt, phase="train",
                         sde=create_sde(opt["sdes"][train_opt["which_sde"]]),
                         image_size=opt.get("resolution") or 224, seed=seed, device=device)
    if any_gt_only and not model.degrade_on_device:
        raise ValueError(
            "datasets.*.gt_only requires models.%s.degrade_on_device: true "
            "(the LQ images exist only as on-device synthesis)" % which_model)
    logger.info("device: %s", model.device)

    resume_epoch = resume_iter = 0
    if resume_state_path:
        resume_epoch, resume_iter = model.resume_training(resume_state_path)
        opt = check_resume(opt, resume_iter)
        load_dir, bundle_name = osp.split(opt["path"]["pretrain_model_DN"])
        model.load(load_dir, bundle_name.rsplit("_DN.ckpt", 1)[0],
                   load_ema=not model.ema_restored)
        logger.info("resumed from epoch %d iter %d", resume_epoch, resume_iter)
        resume_epoch += 1  # the reference re-enters at the next epoch

    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True
        logger.warning("signal %d received - checkpointing before exit", signum)

    handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            handlers[sig] = signal.signal(sig, on_signal)
        except (ValueError, OSError):
            pass  # not the main thread
    try:
        return train(model, opt, train_loader, val_loader, seed, resume_epoch, resume_iter,
                     preempted, logger)
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        for h in logger.handlers[:]:
            logger.removeHandler(h)
            h.close()


def train(model, opt, train_loader, val_loader, seed, resume_epoch, resume_iter, preempted,
          logger):
    """The epochs of ``main`` from ``resume_epoch``; returns the engine."""
    train_opt = opt["train"]
    nepoch = train_opt["nepoch"]
    print_freq = (opt["logger"] or {}).get("print_freq") or 100
    save_freq = (opt["logger"] or {}).get("save_checkpoint_freq") or 1000
    val_freq = train_opt.get("val_freq") or 10**9

    def save(epoch, current_iter):
        model.save(opt["path"]["models"], current_iter)
        model.save_training_state(opt["path"]["training_state"], epoch, current_iter)

    current_iter = resume_iter
    for epoch in range(resume_epoch, nepoch):
        train_loader.set_epoch(epoch)
        model.reinit_loss_message()
        epoch_start = time.time()
        for batch in train_loader:
            current_iter += 1
            model.optimize_parameters(batch, seeded_generator(model.device, seed, current_iter),
                                      epoch=epoch)
            if current_iter % print_freq == 0:
                logger.info("epoch %d iter %d lr %.3e %s", epoch, current_iter,
                            model.get_current_learning_rate(epoch), model.get_loss_message())
            if current_iter % save_freq == 0:
                save(epoch, current_iter)
                logger.info("checkpoint saved at iter %d", current_iter)
            if preempted["flag"]:
                save(epoch, current_iter)
                logger.info("preemption checkpoint saved at iter %d", current_iter)
                return model
            if val_loader is not None and current_iter % val_freq == 0:
                validate(model, val_loader, opt, seed, current_iter, logger)
        logger.info("epoch %d done in %.1fs, %s", epoch, time.time() - epoch_start,
                    model.get_loss_message())
        if (epoch + 1) % 5 == 0:
            save(epoch, current_iter)

    model.save(opt["path"]["models"], "latest")
    model.save_training_state(opt["path"]["training_state"], nepoch - 1, current_iter)
    logger.info("training complete at iter %d", current_iter)
    return model


def validate(model, val_loader, opt, seed: int, current_iter: int, logger) -> dict:
    """Restore up to ``MAX_VAL`` validation batches with ``model.test``; log
    the mean PSNR, SSIM and RMSE of their first images and write each
    ``LQ|pred|GT`` triptych; returns the metrics' lists."""
    metrics = {"PSNR": [], "SSIM": [], "RMSE": []}
    for vi, vbatch in enumerate(val_loader):
        if vi >= MAX_VAL:
            break
        pred = model.test(vbatch, seeded_generator(model.device, seed, current_iter, vi))
        pred = pred.float().cpu().numpy()
        m = eval_restoration(pred[0, ..., 0], vbatch["target"][0, ..., 0])
        for k in metrics:
            metrics[k].append(m[k])
        concat = np.concatenate([vbatch["input"][0, ..., 0], pred[0, ..., 0],
                                 vbatch["target"][0, ..., 0]], axis=-1)
        save_raw(concat, osp.join(opt["path"]["val_images"],
                                  f"{current_iter}_{vi}_{concat.shape[-1]}x{concat.shape[-2]}x1.raw"))
    logger.info("VAL iter %d: PSNR %.4f SSIM %.4f RMSE %.4f", current_iter,
                float(np.mean(metrics["PSNR"])), float(np.mean(metrics["SSIM"])),
                float(np.mean(metrics["RMSE"])))
    return metrics


if __name__ == "__main__":
    main()
