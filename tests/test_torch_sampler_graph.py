"""The compiled sampler's pieces that run on the CPU: the per-call coefficient
tables of both SDEs, the table-driven step loop against the JAX samplers,
and the compiled sampler's cache key. The CUDA graph itself is held against
the eager loop on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The tables are checked twice: bit for bit against the per-step float32
scalar arithmetic the port used before the tables (so the samplers' values
are unchanged), and against the float64 numpy form of the same formulas.
The samplers get an oracle predictor written twice (torch, jnp) and JAX's
own draws, so the loop and the step algebra are compared, not a UNet."""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.sde import DriftSDE as JaxDriftSDE
from instancediff_tpu.sde.ddpm_sde import DDPMSDE as JaxDDPMSDE

from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.engine import SamplingEngine, graph_key, weights_version
from instancediff_torch.ops.fused_gn_conv import packed_copies, packed_weights
from instancediff_torch.sde import DDPMSDE, DriftSDE, strided_sampling_grid
from instancediff_torch.serving import Restorer

from test_torch_engine import _jax_noise

GRIDS = [(None, 0.0), (None, 0.5), (None, 1.0), (4, 0.0), (4, 0.5), (4, 1.0), (6, 0.0),
         (6, 0.5), (6, 1.0)]


def _scalar_rows(kind, sde, sample_steps, eta):
    """The per-step float32 scalar arithmetic of the port before the
    tables: one row per step, each coefficient a 0-d float32 tensor."""
    rows = []
    for t, tp in zip(*strided_sampling_grid(sde.T, sample_steps)):
        if kind == "drift":
            sig_t, sig_p = sde.sigmas[t], sde.sigmas[tp]
            ratio = torch.where(sig_t > 0, sig_p / torch.clamp(sig_t, min=1e-12),
                                torch.zeros_like(sig_t))
            c = eta * sig_p * torch.sqrt(torch.clamp(1.0 - ratio**2, 0.0, 1.0))
            carry = torch.sqrt(torch.clamp(sig_p**2 - c**2, min=0.0))
            rows.append([t, tp, float(sde.drift_schedule[t]), float(sde.drift_schedule[tp]),
                         float(sig_t), float(carry), float(c)])
        else:
            abar_t, abar_p = sde.alphas_bar[t], sde.alphas_bar[tp]
            s = torch.tensor(sde.max_sigma, dtype=torch.float32)
            sigma2 = eta**2 * (1.0 - abar_p) / (1.0 - abar_t) * (1.0 - abar_t / abar_p)
            sigma2 = torch.clamp(sigma2, torch.zeros(()), 1.0 - abar_p)
            noise = torch.sqrt(sigma2) if tp > 0 else torch.zeros(())
            carry = torch.sqrt(torch.clamp(1.0 - abar_p - sigma2, min=0.0))
            rows.append([t, tp] + [float(v) for v in (
                torch.sqrt(abar_t), s * torch.sqrt(1.0 - abar_t), torch.sqrt(abar_p),
                s * carry, s * noise)])
    return np.asarray(rows, dtype=np.float32)


def _float64_rows(kind, T, sample_steps, eta):
    """The same formulas in float64 numpy, from float64 schedules."""
    t_hi, t_lo = (np.asarray(g) for g in strided_sampling_grid(T, sample_steps))
    t = np.arange(T + 1, dtype=np.float64)
    if kind == "drift":  # the sigmoid schedule (scale 6) for both levels, max_sigma 0.4
        raw = 1.0 / (1.0 + np.exp(-6.0 * (2.0 * t / T - 1.0)))
        lo, hi = 1.0 / (1.0 + np.exp(6.0)), 1.0 / (1.0 + np.exp(-6.0))
        level = (raw - lo) / (hi - lo)
        level[0], level[-1] = 0.0, 1.0
        sig = 0.4 * np.sqrt(level)
        sig_t, sig_p = sig[t_hi], sig[t_lo]
        ratio = np.where(sig_t > 0, sig_p / np.maximum(sig_t, 1e-12), 0.0)
        c = eta * sig_p * np.sqrt(np.clip(1.0 - ratio**2, 0.0, 1.0))
        carry = np.sqrt(np.clip(sig_p**2 - c**2, 0.0, None))
        return np.stack([t_hi, t_lo, level[t_hi], level[t_lo], sig_t, carry, c], axis=1)
    f = np.cos((t / T + 0.008) / 1.008 * np.pi / 2.0) ** 2  # cosine alpha-bar, s = 1
    abar = np.clip(f / f[0], 1e-8, 1.0)
    abar_t, abar_p = abar[t_hi], abar[t_lo]
    sigma2 = np.clip(eta**2 * (1.0 - abar_p) / (1.0 - abar_t) * (1.0 - abar_t / abar_p),
                     0.0, 1.0 - abar_p)
    noise = np.where(t_lo > 0, np.sqrt(sigma2), 0.0)
    carry = np.sqrt(np.clip(1.0 - abar_p - sigma2, 0.0, None))
    return np.stack([t_hi, t_lo, np.sqrt(abar_t), np.sqrt(1.0 - abar_t), np.sqrt(abar_p),
                     carry, noise], axis=1)


@pytest.mark.parametrize("kind", ["drift", "ddpm"])
@pytest.mark.parametrize("sample_steps,eta", GRIDS)
def test_coeff_table_rows(kind, sample_steps, eta):
    """Every row of the full T=100 grid and of the strided grids of 4 and 6
    steps, at eta 0, 0.5 and 1, within 1e-6 of float64. The last two columns
    (drift: carry and c; DDPM: s*carry and s*sigma) are square roots of
    float32 differences that cancel (1 - ratio^2, 1 - abar_p - sigma^2):
    four float32 roundings of terms up to 1 leave an error e <= 4 * 2^-23 in
    the root's argument u, which moves the root by up to
    e / (sqrt(u + e) + sqrt(u)) (2e-5 here where the root is near 0), so
    those two are held to 1e-6 plus that."""
    sde = DriftSDE(T=100) if kind == "drift" else DDPMSDE(T=100)
    table = sde.coeff_table(sample_steps, eta)
    assert table.dtype == torch.float32 and table.shape[1] == len(sde.COLUMNS) == 7
    assert table.shape[0] == len(strided_sampling_grid(100, sample_steps)[0])
    got = table.numpy()
    np.testing.assert_array_equal(got, _scalar_rows(kind, sde, sample_steps, eta))
    want = _float64_rows(kind, 100, sample_steps, eta)
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=0, atol=1e-6)
    root_err = 4 * float(np.finfo(np.float32).eps)
    tol = 1e-6 + root_err / (np.sqrt(want[:, 5:] ** 2 + root_err) + want[:, 5:])
    np.testing.assert_array_less(np.abs(got[:, 5:] - want[:, 5:]), tol)


def _torch_drift_oracle(x, row):
    t = row[0]
    return torch.tanh(x) * 0.3 + 0.01 * t, 0.2 * x - 0.05 * t


def _jax_drift_oracle(x, t_b):
    t = t_b.astype(jnp.float32)[:, None, None, None]
    return jnp.tanh(x) * 0.3 + 0.01 * t, 0.2 * x - 0.05 * t


def _torch_eps_oracle(x, row):
    return torch.sin(x) * 0.8 + 0.02 * row[0]


def _jax_eps_oracle(x, t_b):
    return jnp.sin(x) * 0.8 + 0.02 * t_b.astype(jnp.float32)[:, None, None, None]


MU = np.random.default_rng(4).uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
KEY = 11
CASES = [("drift", 0.0), ("drift", 1.0), ("ddpm", 0.0), ("ddpm", 1.0)]


@pytest.fixture(scope="module")
def jax_samples():
    """The JAX samplers at T=4 for every case of ``CASES``, in one jit (one
    compile), with ``jax.random.key(KEY)``."""
    drift, ddpm = JaxDriftSDE(T=4, max_sigma=0.4), JaxDDPMSDE(T=4)

    def run(key, mu):
        return [drift.reverse_ddpm(key, mu, _jax_drift_oracle, eta=eta) if kind == "drift"
                else ddpm.reverse_ddpm(key, mu, _jax_eps_oracle, eta=eta)
                for kind, eta in CASES]

    out = jax.jit(run)(jax.random.key(KEY), jnp.asarray(MU))
    return {case: np.asarray(x) for case, x in zip(CASES, out)}


@pytest.mark.parametrize("kind,eta", CASES, ids=[f"{k}_eta{e:g}" for k, e in CASES])
def test_table_driven_loop_matches_jax_sampler(jax_samples, kind, eta):
    """``reverse_ddpm`` (the eager loop over the step body the engines
    capture) against the JAX ``lax.scan`` sampler at T=4, float32, with
    JAX's draws fed in."""
    eps, zs = _jax_noise(jax.random.key(KEY), MU.shape, 4)
    sde = DriftSDE(T=4, max_sigma=0.4) if kind == "drift" else DDPMSDE(T=4)
    oracle = _torch_drift_oracle if kind == "drift" else _torch_eps_oracle
    got = sde.reverse_ddpm(torch.from_numpy(MU), oracle, eta=eta, init_noise=torch.tensor(eps),
                           step_noise=[torch.tensor(z) for z in zs])
    np.testing.assert_allclose(got.numpy(), jax_samples[(kind, eta)], rtol=0, atol=1e-4)


def test_step_noise_must_cover_every_step():
    sde = DriftSDE(T=4)
    mu = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="3 entries for 4 sampler steps"):
        sde.reverse_ddpm(mu, _torch_drift_oracle, step_noise=[mu] * 3)


def test_graph_key_changes_with_what_the_graph_bakes_in():
    base = dict(shape=(8, 256, 256, 1), n_steps=4, eta=1.0, use_ema=True,
                image_context=True, degra_context=False)
    key = graph_key(**base)
    assert key == graph_key(**dict(base, shape=[8, 256, 256, 1], eta=1))
    for change in (dict(n_steps=100), dict(eta=0.0), dict(use_ema=False),
                   dict(shape=(4, 256, 256, 1)), dict(shape=(8, 128, 128, 1)),
                   dict(image_context=False), dict(degra_context=True)):
        assert graph_key(**dict(base, **change)) != key, change


def test_engine_key_resolves_defaults_and_is_shared_by_padded_requests():
    """An engine's key: ``sample_steps=None`` is the full grid and
    ``eta=None`` the SDE's eta; a 3-image request padded by the Restorer to
    its batch of 4 gets the key of a full batch, so it replays that graph."""
    seen = []
    fake = SimpleNamespace(device=torch.device("cpu"), type_map={"a": 0, "b": 1},
                           context_dim=4, sde=DriftSDE(T=10, eta=1.0), dtype=torch.bfloat16)

    def spy(batch, generator, **kw):
        seen.append(np.asarray(batch["input"]).shape)
        return torch.zeros(np.asarray(batch["input"]).shape)

    fake.test = spy

    def key(shape, **kw):
        inputs = {"mu": torch.zeros(shape), "img_ctx": torch.zeros(shape[0], 1, 4)}
        kw = dict(dict(use_ema=True, sample_steps=None, eta=None), **kw)
        return SamplingEngine._graph_key(fake, inputs, kw["use_ema"], kw["sample_steps"],
                                         kw["eta"])

    r = Restorer(fake, batch_size=4, device="cpu")
    r.restore(np.zeros((4, 6, 6, 1), np.float32), "a")
    r.restore(np.zeros((3, 6, 6, 1), np.float32), ["a", "b", "b"])
    assert seen == [(4, 6, 6, 1)] * 2
    k = key(seen[0])
    assert key(seen[1]) == k == key(seen[0], sample_steps=10, eta=1.0)
    assert key(seen[0], sample_steps=4) != k
    assert key(seen[0], eta=0.0) != k
    assert key(seen[0], use_ema=False) != k
    assert key((2, 6, 6, 1)) != k


@pytest.fixture(scope="module")
def cpu_engine():
    settings = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16,
                    text_module="scoremap", score_map_chan=4, score_map_ngf=8,
                    num_res_blocks=1)
    return CLIPDDPMEngine(settings, sde=DDPMSDE(T=4), tiny_text_encoder=True, device="cpu")


def test_cpu_engine_runs_eagerly_and_refuses_to_compile(cpu_engine):
    batch = {"input": np.zeros((2, 16, 16, 1), np.float32), "type_idx": np.array([0, 3])}
    default = cpu_engine.test(batch, torch.Generator().manual_seed(0), sample_steps=2)
    eager = cpu_engine.test(batch, torch.Generator().manual_seed(0), sample_steps=2,
                            compiled=False)
    torch.testing.assert_close(default, eager, rtol=0, atol=0)
    assert cpu_engine.graphs == {} and cpu_engine.captures == 0
    with pytest.raises(ValueError, match="compiled=True captures a CUDA graph"):
        cpu_engine.test(batch, compiled=True)


def test_weights_version_sees_in_place_updates_of_the_step_nets(cpu_engine):
    """A compiled call recaptures when this changes: an in-place update of a
    parameter the step reads (as ``utils.convert.load_engine`` or an EMA
    step makes), inside inference mode too, changes it; an update of the
    other nets does not."""
    ema = weights_version(cpu_engine._step_nets(True))
    assert ema == weights_version(cpu_engine._step_nets(True))
    with torch.no_grad():
        p = next(cpu_engine._step_nets(False)[0].parameters())
        p.copy_(p.clone())
    assert weights_version(cpu_engine._step_nets(True)) == ema
    with torch.inference_mode():
        p = next(cpu_engine._step_nets(True)[0].parameters())
        p.copy_(p.clone())
    assert weights_version(cpu_engine._step_nets(True)) != ema


def test_packed_copies_are_the_packed_weights_a_graph_reads():
    """``packed_copies`` returns the copy ``packed_weights`` keeps on each
    parameter packed so far; an in-place update repacks into a new tensor,
    so a graph's owner that kept the old list still holds the old copy."""
    w = torch.nn.Parameter(torch.randn(3, 3, 40, 8, generator=torch.Generator().manual_seed(0)))
    other = torch.nn.Parameter(torch.zeros(3, 3, 8, 8))
    packed = packed_weights(w, 8)
    kept = packed_copies([w, other])
    assert len(kept) == 1 and kept[0] is packed
    with torch.no_grad():
        w.mul_(2.0)
    repacked = packed_weights(w, 8)
    assert repacked is not packed and packed_copies([w])[0] is repacked
    torch.testing.assert_close(repacked, 2.0 * kept[0], rtol=0, atol=0)
