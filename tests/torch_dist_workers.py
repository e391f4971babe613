"""Ranks of the CPU data-parallel tests (``tests/test_torch_parallel.py``):
each function runs as one rank of a gloo world in a process of its own,
started by ``run_world``. This module imports torch and the port only (no
JAX); a fork server that has imported them once forks every rank, so a rank
starts in well under a second. Every rank and the rendezvous have a
timeout, so a rank that hangs fails the test instead of the run."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import traceback

import numpy as np
import torch

WORLD_TIMEOUT = 120  # seconds for a whole world, spawn to results
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def run_world(fn, world: int, *args, timeout: float = WORLD_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined by
    the launcher's environment on a free localhost port; returns the ranks'
    results in rank order and raises with a rank's traceback if one
    failed, or if the world did not finish within ``timeout``."""
    return finish_world(start_world(fn, world, *args), timeout)


# the modules every rank imports, loaded once by the fork server whose forks
# become the ranks (a rank started from scratch spends seconds importing torch)
PRELOAD = ["numpy", "torch", "torch.distributed", "torch_dist_workers",
           "instancediff_torch.models.drift_model", "instancediff_torch.models.ddpm_model",
           "instancediff_torch.serving", "instancediff_torch.parallel.spatial",
           "instancediff_torch.parallel.mesh"]


def _context():
    """The fork server context (a server process that has imported
    ``PRELOAD`` and nothing of JAX forks each rank)."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    return ctx


def start_world(fn, world: int, *args) -> tuple:
    """``run_world``'s first half: the ranks started (the caller may work
    meanwhile); ``finish_world`` collects them."""
    from instancediff_torch.parallel import free_port

    ctx = _context()
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, port, queue, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs, queue


def finish_world(started: tuple, timeout: float = WORLD_TIMEOUT) -> list:
    """The ranks' results of a ``start_world`` world, as ``run_world``."""
    procs, queue = started
    world = len(procs)
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, err, out = queue.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = out
    except queue_mod.Empty:
        errors.append(f"the world did not finish in {timeout} s (ranks done: {sorted(results)})")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


def _rank_main(fn, rank, world, port, queue, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        queue.put((rank, None, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which fails the test
        queue.put((rank, traceback.format_exc(), None))


def golden_engine(name: str):
    """The port's engine of a train-golden case, seeded as the golden's JAX
    engine (``tools/make_train_golden.py``)."""
    from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
    from instancediff_torch.models.drift_model import CLIPDriftEngine
    from instancediff_torch.sde import DDPMSDE, DriftSDE
    from instancediff_torch.utils.convert import flax_params, load_flax_params
    from tools import make_train_golden as golden

    kind, dtype, kw = golden.CASES[name]
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    sde_cls, cls, extra = ((DriftSDE, CLIPDriftEngine, golden.DRIFT) if kind == "drift"
                           else (DDPMSDE, CLIPDDPMEngine, golden.DDPM))
    nets = (golden.SETTINGS, golden.SETTINGS) if kind == "drift" else (golden.SETTINGS,)
    eng = cls(*nets, sde=sde_cls(T=golden.T, max_sigma=golden.MAX_SIGMA[kind]), dtype=dt,
              device="cpu", if_train=True, **golden.COMMON, **extra, **kw)
    keys = golden.trained_keys(kind)
    state = golden.seeded_state({**{k: flax_params(eng.nets[k]) for k in keys},
                                 "text": flax_params(eng.text_encoder)})
    for k in keys:
        load_flax_params(eng.nets[k], state[k])
        load_flax_params(eng.nets[k[0] + "_ema"], state[k])
    load_flax_params(eng.text_encoder, state["text"])
    return eng


def golden_steps(eng, draws: dict, batch: dict) -> tuple:
    """The golden's two steps on ``eng`` with ``draws`` (per step ``t``,
    ``std_noise`` and, with on-device degradation, ``deg_noise``): the loss
    terms of each step, Adam's first moments (flax layout) before the steps
    and after each, and the trained nets' parameters after step 2."""
    from instancediff_torch.utils.convert import adam_state, flax_params

    def moments():
        return {k: adam_state(eng.optimizers[k], eng.nets[k])["inner_state"]["1"]["mu"]
                for k in eng.optimizers}

    losses, mus = [], [moments()]
    for i in range(2):
        kw = {k: torch.from_numpy(np.ascontiguousarray(draws[k][i]))
              for k in ("t", "std_noise") if k in draws}
        if "deg_noise" in draws:
            kw["deg_noise"] = list(torch.from_numpy(np.ascontiguousarray(draws["deg_noise"][i])))
        eng.optimize_parameters(batch, epoch=i, **kw)
        losses.append(dict(eng.loss_info["latest"]))
        mus.append(moments())
    return losses, mus, {k: flax_params(eng.nets[k]) for k in eng.optimizers}


def shard_draws(draws: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s part of each step's draws (the batch axis: 1 for
    ``t`` and ``std_noise`` [steps, B, ...], 2 for ``deg_noise`` [steps, 5,
    B, ...])."""
    out = {}
    for k, v in draws.items():
        axis = 2 if k == "deg_noise" else 1
        b = v.shape[axis] // world
        out[k] = np.take(v, range(rank * b, (rank + 1) * b), axis=axis)
    return out


def golden_rank(rank: int, world: int, cases: dict) -> dict:
    """Each case of ``cases`` ({name: the golden's draws}) on this rank's
    part of the golden batch, after rank 0's weights are broadcast (rank 1
    first perturbs its own, which the broadcast must undo), the collectives
    in 64 KiB buckets; also ``any_rank`` of a flag only rank 1 sets."""
    from instancediff_torch import parallel
    from tools import make_train_golden as golden

    parallel.init_distributed("cpu", timeout=GROUP_TIMEOUT)
    parallel.BUCKET_BYTES = 2**16  # a tiny net's gradients in several buckets
    try:
        out = {"world": parallel.world_size(), "rank": parallel.rank(),
               "any_rank1": parallel.any_rank(rank == 1), "any_none": parallel.any_rank(False)}
        for name, draws in cases.items():
            eng = golden_engine(name)
            if rank == 1:
                with torch.no_grad():
                    for p in eng.nets.parameters():
                        p.add_(1.0)
            parallel.broadcast_module_(eng.nets)
            batch = parallel.shard_batch(golden.batch())
            out[name] = golden_steps(eng, shard_draws(draws, rank, world), batch)
        return out
    finally:
        parallel.shutdown()


def trainum_rank(rank: int, world: int, cfg: str, cwd: str) -> dict:
    """``tools/trainUM --launcher pytorch --platform cpu`` on ``cfg`` as one
    rank, from ``cwd``: the trained nets' parameters, the step and the
    timesteps this rank drew at each step."""
    from instancediff_torch.sde import DriftSDE
    from instancediff_torch.tools import trainUM
    from instancediff_torch.utils.convert import flax_params

    os.chdir(cwd)
    drawn = []
    real = DriftSDE.forward_diffusion

    def record(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        drawn.append(out[0].reshape(-1).tolist())
        return out

    DriftSDE.forward_diffusion = record
    eng = trainUM.main(["-opt", cfg, "--launcher", "pytorch", "--platform", "cpu"])
    return {"step": eng.step, "t": drawn,
            "params": {k: flax_params(eng.nets[k]) for k in eng.optimizers}}


def cuda_gloo_rank(rank: int, world: int) -> dict:
    """One rank of a gloo world whose ranks share cuda:0: the mean of each
    rank's CUDA tensors, and a module broadcast from rank 0 (rank 1's
    weights differ before it)."""
    from instancediff_torch import parallel

    dev = parallel.init_distributed("cuda:0", backend="gloo", timeout=GROUP_TIMEOUT)
    parallel.BUCKET_BYTES = 64  # one bucket per tensor
    try:
        tensors = [torch.full((5, 3), float(rank + 1), device=dev),
                   torch.arange(7.0, device=dev) * (rank + 1)]
        n = parallel.all_reduce_mean_(tensors)
        net = torch.nn.Linear(4, 3).to(dev)
        with torch.no_grad():
            for p in net.parameters():
                p.fill_(float(rank))
        parallel.broadcast_module_(net)
        return {"bytes": n, "device": str(tensors[0].device),
                "mean": [t.cpu().numpy() for t in tensors],
                "net": [p.detach().cpu().numpy() for p in net.parameters()]}
    finally:
        parallel.shutdown()


# ---------------------------------------------------------------- spatial

def spatial_engine(settings: dict, engine_kw: dict, state: dict, text_params: dict,
                   kind: str = "drift", T: int = 3, max_sigma: float = 0.4):
    """The port's sampling engine of ``settings`` on the CPU, filled with
    the flax trees ``state`` (per net) and ``text_params`` where given."""
    from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
    from instancediff_torch.models.drift_model import CLIPDriftEngine
    from instancediff_torch.sde import DDPMSDE, DriftSDE
    from instancediff_torch.utils.convert import load_engine

    if kind == "drift":
        eng = CLIPDriftEngine(settings, settings, sde=DriftSDE(T=T, max_sigma=max_sigma),
                              device="cpu", **engine_kw)
    else:
        eng = CLIPDDPMEngine(settings, sde=DDPMSDE(T=T), device="cpu", **engine_kw)
    return eng if state is None else load_engine(eng, state, text_params)


def spatial_rank(rank: int, world: int, cases: dict, pair_cases: dict, served=None) -> dict:
    """Each case of ``cases`` ({name: (engine args, batch, test kwargs)}) as
    one rank of a gloo world: the engine's ``test`` on the whole batch with
    the images' height split over the world (``spatial=``), the whole
    images back on every rank; each of ``pair_cases`` the same over two
    ranks, in the groups {0, 1}, {2, 3}, ... A case whose kwargs hold
    ``seed`` draws its noise from a generator seeded with it; the others
    pass the noise. With ``served`` = (config, images, names, testUM
    argv, restore argv): ``Restorer.from_config(config, spatial=world)``
    (the engine's initial weights from one torch seed) and its restore of
    ``images`` (``"served"``), and on rank 0 the same with ``spatial=0``
    (``"served_whole"``); then ``testUM`` with ``--spatial world``
    (``"testum"``) and ``tools/restore`` with ``--spatial world`` (the
    paths it wrote, ``"restore"``)."""
    import torch.distributed as dist

    from instancediff_torch import parallel
    from instancediff_torch.parallel.spatial import SpatialGroup
    from instancediff_torch.serving import Restorer

    parallel.init_distributed("cpu", timeout=GROUP_TIMEOUT)
    try:
        pairs = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
        runs = [(SpatialGroup(), cases), (SpatialGroup(pairs[rank // 2]), pair_cases)]
        out = {}
        for sp, (name, (args, batch, kw)) in ((sp, c) for sp, cs in runs for c in cs.items()):
            eng = spatial_engine(*args)
            kw = dict(kw)
            if "seed" in kw:
                kw["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
            kw = {k: [torch.from_numpy(z) for z in v] if k == "step_noise" else
                  torch.from_numpy(v) if k == "init_noise" else v for k, v in kw.items()}
            out[name] = eng.test(batch, spatial=sp, **kw).numpy()
            out[name + "_world"] = sp.world
        if served is not None:
            from instancediff_torch.tools import restore, testUM

            cfg, images, names, argv, restore_argv = served
            for key, spatial in (("served", world), ("served_whole", 0))[:2 - bool(rank)]:
                torch.manual_seed(0)
                r = Restorer.from_config(cfg, batch_size=2, sample_steps=2, device="cpu",
                                         spatial=spatial)
                out[key] = r.restore(images, names)
                out[key + "_world"] = r.sp.world if r.sp else 1
            torch.manual_seed(0)
            out["testum"] = testUM.main(argv + ["--spatial", str(world)])
            torch.manual_seed(0)
            out["restore"] = restore.main(restore_argv + ["--spatial", str(world)])
        return out
    finally:
        parallel.shutdown()


# ---------------------------------------------------------------- FSDP

def fsdp_rank(rank: int, world: int, name: str, draws: dict, tmp: str) -> dict:
    """The train golden's case ``name`` on a 2 x 2 dp x fsdp grid (this
    rank's dp slice of the batch and of the draws): the golden's two steps,
    their loss terms and Adam's first moments (gathered), the trained nets'
    parameters after them, and the bytes held against unsharded; then the
    same case on a 1 x 4 grid (every rank the whole batch), whose ``.state``
    rank 0 writes under ``tmp``."""
    from instancediff_torch import parallel
    from instancediff_torch.parallel.mesh import Grid
    from instancediff_torch.utils.convert import adam_state, flax_params
    from tools import make_train_golden as golden

    from instancediff_torch.parallel.mesh import gather_params, shard_params_fsdp

    parallel.init_distributed("cpu", timeout=GROUP_TIMEOUT)
    try:
        out = {}
        for dp, fsdp in ((2, 2), (1, 4)):
            grid = Grid(dp, fsdp)
            tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(3)}
            shards = shard_params_fsdp(tree, grid)
            out[f"roundtrip_{dp}x{fsdp}"] = (
                {k: (tuple(v[0].shape), v[1]) for k, v in shards.items()},
                {k: v.numpy() for k, v in gather_params(shards, grid).items()})
            eng = golden_engine(name)
            eng.shard_fsdp(grid)
            batch = parallel.shard_batch(golden.batch(), grid.dp_rank, dp)
            mine = shard_draws(draws, grid.dp_rank, dp)

            def moments():
                mus = {}
                for k in eng.optimizers:
                    eng.fsdp.gather_()
                    mus[k] = adam_state(eng.fsdp.adam_view(k), eng.nets[k])[
                        "inner_state"]["1"]["mu"]
                eng.fsdp.release_()
                return mus

            losses, mus = [], [moments()]
            for i in range(2):
                kw = {k: torch.from_numpy(np.ascontiguousarray(mine[k][i]))
                      for k in ("t", "std_noise")}
                eng.optimize_parameters(batch, epoch=i, **kw)
                losses.append(dict(eng.loss_info["latest"]))
                mus.append(moments())
            eng.fsdp.gather_()
            params = {k: flax_params(eng.nets[k]) for k in eng.optimizers}
            eng.fsdp.release_()
            state_dir = os.path.join(tmp, f"{dp}x{fsdp}")
            written = eng.save_training_state(state_dir, 1, 2)
            out[f"{dp}x{fsdp}"] = {"losses": losses, "mus": mus, "params": params,
                                   "bytes": eng.fsdp.held_bytes(), "written": written,
                                   "grid": (grid.dp_rank, grid.fsdp_rank)}
        return out
    finally:
        parallel.shutdown()
