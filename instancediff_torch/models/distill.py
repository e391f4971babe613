"""Progressive few-step distillation of the dual-net drift sampler (port of
``instancediff_tpu/models/distill.py``).

A student learns to take one deterministic step where its teacher takes two
(Salimans & Ho 2022), halving the sampler's step count per phase. The eta=0
reverse step is linear in the two nets' predictions, so the teacher's two
steps t -> t_mid -> t_lo compose into one step whose predictions are the
increment-weighted averages

    D*   = [(s_d[t]-s_d[m]) D_1 + (s_d[m]-s_d[l]) D_2] / (s_d[t]-s_d[l])
    eps* = [(sig_t-carry_1) e_1 + (sig_m-carry_2) e_2] / (sig_t-sig_l),

(carry the posterior's carried-noise coefficient, sigma_prev at eta=0); a
student predicting (D*, eps*) at t reproduces the teacher's two-step
endpoint. With a stochastic teacher (``teacher_eta`` > 0) the same targets
are the z1-conditioned mean of its two-step chain; ``z1_correction`` adds
the exact ``-c1 z1`` term.

The teacher's two predictions run under ``torch.no_grad`` on the teacher
nets' sampling path, so on CUDA they run the fused conv, ``gn_channel_affine``
and flash kernels; the student's forward and backward run the plain
differentiable path, as a train step does (``engine.optimize_parameters``).
Distilled weights sample with ``engine.test(..., sample_steps=N, eta=0.0)``.

Torch cannot reproduce JAX's threefry bits: each step's random draws (the
pair index per sample, the marginal's noise, the teacher's first-step noise)
are injectable, or drawn from a ``torch.Generator`` in JAX's order."""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..sde.schedules import strided_sampling_grid
from .engine import score_map_loss
from .layers import cast_compute_
from .optim import cosine_annealing_lr

OPTIMIZE_TYPES = ("inputRes", "predict_noise", "")
LOSS_KEYS = ("l", "dl", "nl", "dsml", "nsml")


def distill_grid(T: int, student_steps: int):
    """``(t_hi, t_mid, t_lo)``: int64 tensors of length ``student_steps``.
    The student's pairs (t_hi, t_lo) are ``strided_sampling_grid(T, N)``'s;
    t_mid is the teacher's 2N-grid point between them. Raises ``ValueError``
    when 2N > T or the grids do not nest, as JAX does."""
    N = int(student_steps)
    if 2 * N > T:
        raise ValueError(f"teacher grid needs 2*{N} <= T={T}")
    g2 = np.unique(np.round(np.linspace(0, T, 2 * N + 1)).astype(np.int64))
    if len(g2) != 2 * N + 1:
        raise ValueError(f"teacher grid for N={N} collides at T={T}")
    s_hi, s_lo = strided_sampling_grid(T, N)
    gs = np.asarray(s_lo[::-1][:1] + s_hi[::-1])
    if not np.array_equal(g2[::2], gs):
        raise ValueError(
            f"student grid (N={N}) is not nested in the teacher 2N-grid at "
            f"T={T}; pick N so round(linspace) points coincide")
    return tuple(torch.from_numpy(g2[a:b:2].copy()) for a, b in ((2, None), (1, -1), (0, -2)))


class Teacher:
    """A frozen snapshot of two nets: deep copies of ``drift_net`` and
    ``noise_net`` held in ``engine``'s compute dtype (bf16 for a bf16
    engine, whose trained nets keep float32 master weights), so their
    forward is the served forward. Its prompt encodings depend only on its
    weights and the frozen text tower: they are computed at the first call
    and kept (``texts``). JAX recomputes them in every step; the values are
    the same."""

    def __init__(self, engine, drift_net: torch.nn.Module, noise_net: torch.nn.Module):
        def frozen(net):
            return cast_compute_(copy.deepcopy(net), engine.dtype).eval().requires_grad_(False)

        self.drift, self.noise = frozen(drift_net), frozen(noise_net)
        self.texts = None

    @classmethod
    def from_engine(cls, engine, ema: bool = True) -> "Teacher":
        """The engine's EMA nets, or its live nets with ``ema=False``."""
        keys = ("d_ema", "n_ema") if ema else ("drift", "noise")
        return cls(engine, engine.nets[keys[0]], engine.nets[keys[1]])

    def encodings(self, engine):
        if self.texts is None:
            with torch.no_grad():
                self.texts = (engine._encode_prompts(self.drift),
                              engine._encode_prompts(self.noise))
        return self.texts


def _check_engine(engine) -> None:
    if engine.optimize_type not in OPTIMIZE_TYPES:
        raise ValueError(
            "distillation is implemented for the reference's live 'inputRes' "
            f"contract only (got optimize_type={engine.optimize_type!r})")
    if not engine.optimizers:
        raise RuntimeError("distillation trains the engine: build it with if_train=True "
                           "(create_model(..., phase='train'))")
    if engine.sde is None:
        raise ValueError("engine has no SDE; pass sde= to the constructor")


def distill_targets(engine, teacher: Teacher, batch, student_steps: int,
                    teacher_eta: float = 0.0, z1_correction: bool = False,
                    pair: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                    z1: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> Dict:
    """The step's inputs and the teacher's composed targets (JAX's
    ``build_distill_step`` up to its ``stop_gradient``s). ``pair`` [B] (the
    index of each sample's (t_hi, t_mid, t_lo)), ``eps`` (the marginal's
    noise, like x0) and ``z1`` (the teacher's first-step noise; zeros at
    ``teacher_eta`` 0) replace draws from ``generator``, in that order.
    Returns ``mu``, ``x_t``, ``t`` (t_hi [B]), ``type_idx``, ``img_ctx``,
    ``degra_ctx``, ``d_tgt`` and ``n_tgt``."""
    sde = engine.sde
    dev = engine.device
    t_hi, t_mid, t_lo = (g.to(dev) for g in distill_grid(sde.T, student_steps))
    mu = engine._tensor(batch["input"], torch.float32)
    x0 = engine._tensor(batch["target"], torch.float32)
    ty = engine._tensor(batch["type_idx"], torch.int64)
    B = x0.shape[0]
    img_ctx = engine._image_context(batch, B)
    degra_ctx = None
    if engine.use_degra_context:
        with torch.no_grad():
            degra_ctx = engine._encode_text(None)[ty][:, None, :]
    if pair is None:
        pair = torch.randint(0, len(t_hi), (B,), generator=generator, device=dev)
    pair = torch.as_tensor(pair, device=dev).long()
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
    eps = torch.as_tensor(eps, device=dev, dtype=x0.dtype)
    if z1 is None:
        z1 = (torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
              if teacher_eta else torch.zeros_like(x0))
    z1 = torch.as_tensor(z1, device=dev, dtype=x0.dtype)
    th, tm, tl = t_hi[pair], t_mid[pair], t_lo[pair]
    bshape = (B,) + (1,) * (x0.ndim - 1)

    def sd(t):
        return sde.drift_schedule.to(dev)[t].reshape(bshape).to(x0.dtype)

    def sg(t):
        return sde.sigmas.to(dev)[t].reshape(bshape).to(x0.dtype)

    x_t = x0 + sd(th) * (mu - x0) + sg(th) * eps
    texts = teacher.encodings(engine)

    def teacher_predict(x, t):
        # the sampling-time inputRes contract: drift(x - mu, mu), noise(x - mu, x)
        pd, pn, _, _ = engine._dual_forward(teacher.drift, teacher.noise, (x - mu, mu),
                                            (x - mu, x), t, ty, img_ctx, degra_ctx,
                                            plain=False, texts=texts)
        return pd, pn

    with torch.no_grad():
        pd1, pn1 = teacher_predict(x_t, th)
        x_mid = sde.reverse_step_at(x_t, th, tm, pd1, pn1, teacher_eta, z1)
        pd2, pn2 = teacher_predict(x_mid, tm)
        carry1, c1 = sde.posterior_coeffs(sg(th), sg(tm), teacher_eta)
        carry2, _ = sde.posterior_coeffs(sg(tm), sg(tl), teacher_eta)
        dsd1, dsd2 = sd(th) - sd(tm), sd(tm) - sd(tl)
        d_tgt = (dsd1 * pd1 + dsd2 * pd2) / torch.clamp(dsd1 + dsd2, min=1e-8)
        n_num = (sg(th) - carry1) * pn1 + (sg(tm) - carry2) * pn2
        if z1_correction:
            n_num = n_num - c1 * z1
        n_tgt = n_num / torch.clamp(sg(th) - sg(tl), min=1e-8)
    return {"mu": mu, "x_t": x_t, "t": th, "type_idx": ty, "img_ctx": img_ctx,
            "degra_ctx": degra_ctx, "d_tgt": d_tgt, "n_tgt": n_tgt}


def student_step(engine, targets: Dict, lr: float) -> Dict[str, float]:
    """The student's update on ``distill_targets``' output: both nets on
    their plain differentiable path at t_hi (text encodings inside the
    autograd graph), the l2 drift and noise losses plus the score-map
    pyramids against the targets, backward, one Adam step per net at
    ``lr``, the step counter and the EMA. Returns the loss terms (JAX's
    metric keys ``l, dl, nl, dsml, nsml``)."""
    mu, x_t = targets["mu"], targets["x_t"]
    d_tgt, n_tgt = targets["d_tgt"], targets["n_tgt"]
    for opt in engine.optimizers.values():
        opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        pred_drift, pred_noise, d_sms, n_sms = engine._dual_forward(
            engine.nets["drift"], engine.nets["noise"], (x_t - mu, mu), (x_t - mu, x_t),
            targets["t"], targets["type_idx"], targets["img_ctx"], targets["degra_ctx"],
            plain=True)
        dloss = torch.mean((pred_drift - d_tgt) ** 2)
        nloss = torch.mean((pred_noise - n_tgt) ** 2)
        zero = torch.zeros((), device=engine.device)
        dsml = score_map_loss(d_sms, d_tgt) if d_sms and engine.use_dsm else zero
        nsml = score_map_loss(n_sms, n_tgt) if n_sms and engine.use_nsm else zero
        loss = dloss + nloss + dsml + nsml
        loss.backward()
    engine._apply_gradients({key: lr for key in engine.optimizers})
    values = torch.stack([v.detach().float().reshape(())
                          for v in (loss, dloss, nloss, dsml, nsml)]).tolist()
    return dict(zip(LOSS_KEYS, values))


def distill_step(engine, teacher: Teacher, batch, student_steps: int, teacher_eta: float = 0.0,
                 z1_correction: bool = False, pair=None, eps=None, z1=None,
                 generator: Optional[torch.Generator] = None, *, lr: float) -> Dict[str, float]:
    """One distillation step (JAX's ``build_distill_step``): the teacher's
    composed targets (``distill_targets``; injected draws or ``generator``)
    and the student's update (``student_step``) at learning rate ``lr``, the
    same for both nets. Returns the loss terms."""
    _check_engine(engine)
    targets = distill_targets(engine, teacher, batch, student_steps, teacher_eta,
                              z1_correction, pair, eps, z1, generator)
    return student_step(engine, targets, lr)


def distill_phase(engine, student_steps: int, batches: Iterable[Dict], n_steps: int,
                  lr: float = 2e-5, ema_as_teacher: bool = True, teacher_eta: float = 0.0,
                  z1_correction: bool = False, log_every: int = 100, log_fn=None,
                  generator: Optional[torch.Generator] = None) -> Optional[float]:
    """One halving phase, in place on ``engine`` (JAX's ``distill_phase``).

    The teacher is a frozen snapshot of the engine's EMA nets (its live nets
    with ``ema_as_teacher=False``), in the compute dtype (``Teacher``). The
    student starts at the teacher: the live nets and the EMA shadows are
    ``copy_``'d from the float32 weights it was taken from; Adam's moments
    are fresh and the step counter restarts at 0. ``n_steps`` steps over
    ``batches`` (an endless iterator of train batches), the learning rate
    cosine-annealed from ``lr`` to ``lr * 0.01``, the same for both nets,
    draws from ``generator``. The in-place copies and updates move the
    nets' ``weights_version``, so the next compiled sampler call captures a
    new graph: ``engine.test(..., sample_steps=student_steps, eta=0.0)``
    serves the student. Every ``log_every`` steps (and the first) the loss
    terms are recorded and passed to ``log_fn(step, metrics)``. Returns the
    last recorded loss."""
    _check_engine(engine)
    teacher = Teacher.from_engine(engine, ema_as_teacher)
    src = ("d_ema", "n_ema") if ema_as_teacher else ("drift", "noise")
    with torch.no_grad():
        for net_key, ema_key, s in (("drift", "d_ema", src[0]), ("noise", "n_ema", src[1])):
            start = [p.detach().clone() for p in engine.nets[s].parameters()]
            for key in (net_key, ema_key):
                torch._foreach_copy_(list(engine.nets[key].parameters()), start)
    for opt in engine.optimizers.values():
        opt.state.clear()
    engine.step = 0
    engine.reinit_loss_message()
    last = None
    it = iter(batches)
    for s in range(int(n_steps)):
        lr_s = cosine_annealing_lr(s, n_steps, lr, lr * 0.01)
        metrics = distill_step(engine, teacher, next(it), student_steps, teacher_eta,
                               z1_correction, generator=generator, lr=lr_s)
        if log_every and ((s + 1) % log_every == 0 or s == 0):
            engine._record_losses(metrics)
            last = metrics["l"]
            if log_fn is not None:
                log_fn(s + 1, metrics)
    return last
