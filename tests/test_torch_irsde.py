"""The port's IR-SDE (``instancediff_torch/sde/ir_sde.py``) and the last
degradations of ``ops/degradations.py`` against the JAX package on the CPU.

JAX draws its noise from its keys (``key`` for x_T; ``split(fold_in(key,
1), T)`` for the per-step z); the port takes the same draws as tensors.
Tolerances, float32: the tables exactly; the per-sample functions and the
fixed-step loops within 1e-5 of the largest magnitude (summation order and
the last ulp of ``exp``/``tanh`` only); ``ode_sampler`` within ``ODE_TOL`` of
the largest magnitude: the port replicates ``odeint``'s controller and dense
output, so both take the same steps (the same number of evaluations of the
noise predictor, but where an error ratio lies within roundoff of 1) and
differ by roundoff, which the solve amplifies (a 1e-7
relative change of x_T moves JAX's own solution of the UNet case by about
4e-5 of its largest magnitude; the port reads 1.3e-5 from JAX there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.models.unet import LearnableForwardUNetMultiScoreMap as JaxUNet
from instancediff_tpu.ops import degradations as jax_deg
from instancediff_tpu.sde import create_sde as jax_create_sde
from instancediff_tpu.sde.ir_sde import IRSDE as JaxIRSDE

from instancediff_torch.models.unet import LearnableForwardUNetMultiScoreMap
from instancediff_torch.ops import degradations as deg
from instancediff_torch.sde import IRSDE, create_sde, schedule_increment
from instancediff_torch.sde.odeint import odeint
from instancediff_torch.utils import sde_utils
from instancediff_torch.utils.convert import load_flax_params

from test_torch_engine import one_torch_thread, randomize  # noqa: F401

TOL = 1e-5
ODE_TOL = 1e-4
B, RES = 2, 16
SCHEDULES = ("cosine", "linear", "constant")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))
    assert err <= tol * scale, f"max abs err {err:.3g}, largest {scale:.3g}"


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
            rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32))


def oracles(sde_j, sde_p, mu):
    """A bounded, smooth noise predictor on both sides: sigmabar_t * 0.5
    tanh(x - mu), so the score is -0.5 tanh(x - mu)."""
    sb_j = jnp.asarray(sde_j.sigma_bars)

    def jax_fn(x, t):
        return sb_j[t].reshape(-1, 1, 1, 1) * 0.5 * jnp.tanh(x - jnp.asarray(mu))

    def port_fn(x, t):
        return sde_p.sigma_bars[t.long()].reshape(-1, 1, 1, 1) * 0.5 * torch.tanh(
            x - torch.from_numpy(mu))

    return jax_fn, port_fn


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("max_sigma,T", [(0.4, 100), (50.0, 20)])
def test_tables_equal_jax(schedule, max_sigma, T):
    opt = {"class_name": "IRSDE", "T": T, "max_sigma": max_sigma, "schedule": schedule,
           "eps": 0.005}
    want, got = jax_create_sde(dict(opt)), create_sde(dict(opt))
    assert isinstance(got, IRSDE) and isinstance(want, JaxIRSDE)
    assert (got.T, got.max_sigma, got.dt) == (want.T, want.max_sigma, want.dt)
    for name in ("thetas", "thetas_cum", "sigma_bars", "sigmas"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    plain = IRSDE(max_sigma=max_sigma, T=T, schedule=schedule)
    np.testing.assert_array_equal(plain.sigma_bars.numpy(), np.asarray(
        JaxIRSDE(max_sigma=max_sigma, T=T, schedule=schedule).sigma_bars))
    assert sde_utils.IRSDE is IRSDE
    s = torch.linspace(0, 1, 7)
    assert torch.equal(schedule_increment(s), torch.cat([torch.zeros(1), s.diff()]))


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        IRSDE(schedule="sigmoid")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_per_sample_functions_equal_jax(schedule):
    x0, mu = _data()
    j, p = JaxIRSDE(T=100, schedule=schedule), IRSDE(T=100, schedule=schedule)
    key = jax.random.key(4)
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (B,), 1, 101))
    noise = np.asarray(jax.random.normal(kn, x0.shape))
    want = j.forward_diffusion(key, jnp.asarray(x0), jnp.asarray(mu))
    got = p.forward_diffusion(torch.from_numpy(x0), torch.from_numpy(mu),
                              t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    _close(p.mu_bar(torch.from_numpy(x0), torch.from_numpy(mu), torch.from_numpy(t)),
           j.mu_bar(jnp.asarray(x0), jnp.asarray(mu), jnp.asarray(t)))
    _close(p.score_from_noise(torch.from_numpy(noise), torch.from_numpy(t)),
           j.score_from_noise(jnp.asarray(noise), jnp.asarray(t)))
    for tt in (t, np.array([1, 100])):
        _close(p.reverse_optimum_step(torch.from_numpy(x0 - mu), torch.from_numpy(mu),
                                      torch.from_numpy(tt)),
               j.reverse_optimum_step(jnp.asarray(x0 - mu), jnp.asarray(mu), jnp.asarray(tt)))


def test_forward_diffusion_draws_from_the_generator():
    x0, mu = (torch.from_numpy(a) for a in _data())
    sde = IRSDE(T=10)
    a, b = (sde.forward_diffusion(x0, mu, generator=torch.Generator().manual_seed(2))
            for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert 1 <= int(a[0].min()) and int(a[0].max()) <= 10


def _jax_draws(key, shape, T):
    init = np.asarray(jax.random.normal(key, shape))
    steps = [np.asarray(jax.random.normal(k, shape))
             for k in jax.random.split(jax.random.fold_in(key, 1), T)]
    return torch.from_numpy(init), [torch.from_numpy(z) for z in steps]


@pytest.mark.parametrize("stochastic", [True, False])
def test_reverse_sde_equals_jax(stochastic):
    _, mu = _data(1)
    T = 30
    j, p = JaxIRSDE(T=T), IRSDE(T=T)
    fj, fp = oracles(j, p, mu)
    key = jax.random.key(7)
    init, steps = _jax_draws(key, mu.shape, T)
    want_x, want_states = j.reverse_sde(key, jnp.asarray(mu), fj, stochastic=stochastic,
                                        return_states=True)
    got_x, got_states = p.reverse_sde(torch.from_numpy(mu), fp, stochastic=stochastic,
                                      return_states=True, init_noise=init, step_noise=steps)
    assert got_states.shape == (T,) + mu.shape
    _close(got_x, want_x)
    _close(got_states, want_states)
    # the last step (t = 1) adds no noise: its z changes nothing
    other = list(steps[:-1]) + [100 * steps[-1]]
    again = p.reverse_sde(torch.from_numpy(mu), fp, stochastic=stochastic, init_noise=init,
                          step_noise=other)
    assert torch.equal(again, got_x)


def test_reverse_sde_draws_init_then_one_noise_per_step():
    _, mu = _data(1)
    p = IRSDE(T=6)
    _, fp = oracles(JaxIRSDE(T=6), p, mu)
    g = torch.Generator().manual_seed(5)
    draws = torch.randn((7,) + mu.shape, generator=g)
    want = p.reverse_sde(torch.from_numpy(mu), fp, init_noise=draws[0], step_noise=draws[1:])
    got = p.reverse_sde(torch.from_numpy(mu), fp, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want)


def test_reverse_ode_equals_jax():
    _, mu = _data(2)
    T = 30
    j, p = JaxIRSDE(T=T, schedule="linear"), IRSDE(T=T, schedule="linear")
    fj, fp = oracles(j, p, mu)
    key = jax.random.key(8)
    init, _ = _jax_draws(key, mu.shape, T)
    want_x, want_states = j.reverse_ode(key, jnp.asarray(mu), fj, return_states=True)
    got_x, got_states = p.reverse_ode(torch.from_numpy(mu), fp, return_states=True,
                                      init_noise=init)
    _close(got_x, want_x)
    _close(got_states, want_states)


def test_odeint_solves_a_known_ode():
    """dy/dt = -y t: y(t) = y0 exp(-t^2/2); the dense output at t1."""
    y0 = torch.tensor([1.0, -2.0, 0.5])
    y, info = odeint(lambda y, t: -y * float(t), y0, 0.0, 2.5, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), y0.numpy() * np.exp(-2.5**2 / 2), rtol=2e-5)
    assert info["nfev"] == 2 + 6 * (info["accepted"] + info["rejected"])


def test_odeint_refuses_a_non_finite_error():
    with pytest.raises(FloatingPointError):
        odeint(lambda y, t: y / 0.0 * float(t), torch.ones(3), 0.0, 1.0)


def jax_ode_sampler(sde, x_T, mu, noise_fn):
    """JAX's ``ode_sampler`` and the number of times its solve called
    ``noise_fn`` (counted on the host)."""
    calls = [0]

    def counted(x, t):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return noise_fn(x, t)

    out = np.asarray(sde.ode_sampler(jnp.asarray(x_T), jnp.asarray(mu), counted))
    return out, calls[0]


def test_ode_sampler_equals_odeint_on_an_oracle():
    """The noise of the forward marginal towards x0, (x - mu_bar_t) /
    sigmabar_t: the probability flow of a point mass, which the solve
    carries to x0."""
    x0, mu = _data(3)
    j, p = JaxIRSDE(T=100), IRSDE(T=100)

    def fj(x, t):
        sb = jnp.asarray(j.sigma_bars)[t].reshape(-1, 1, 1, 1)
        return (x - j.mu_bar(jnp.asarray(x0), jnp.asarray(mu), t)) / sb

    def fp(x, t):
        sb = p.sigma_bars[t.long()].reshape(-1, 1, 1, 1)
        return (x - p.mu_bar(torch.from_numpy(x0), torch.from_numpy(mu), t)) / sb

    x_T = (mu + j.max_sigma * np.asarray(jax.random.normal(jax.random.key(9), mu.shape))
           ).astype(np.float32)
    want, calls = jax_ode_sampler(j, x_T, mu, fj)
    got, info = p.ode_sampler(torch.from_numpy(x_T), torch.from_numpy(mu), fp,
                              return_info=True)
    _close(got, want, ODE_TOL)
    _close(got, x0, 5e-2)  # the solve stops at t = eps, short of x0
    assert info["nfev"] == calls == 2 + 6 * (info["accepted"] + info["rejected"])


UNET = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16, text_module="scoremap",
            score_map_chan=4, if_MultiScoreMap=True, num_res_blocks=1,
            score_map_ch_mult=(1, 1), score_map_ngf=8)


def test_ode_sampler_equals_odeint_on_a_unet():
    """The noise predictor a tiny UNet with every leaf randomised, the same
    converted weights on both sides (the JAX net's init traced for shapes
    only)."""
    rng = np.random.default_rng(10)
    _, mu = _data(4)
    ty = np.array([4, 1], np.int32)
    text = [rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2)]
    jnet = JaxUNet(**UNET)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), mu, mu, jnp.ones((B,), jnp.int32),
                            ty, text_embs=text)
    params = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), rng)
    net = LearnableForwardUNetMultiScoreMap(**UNET)
    load_flax_params(net, params)
    jp = jax.tree.map(jnp.asarray, params)

    def fj(x, t):
        return jnet.apply(jp, x, jnp.asarray(mu), t, jnp.asarray(ty),
                          text_embs=[jnp.asarray(a) for a in text])[0]

    def fp(x, t):
        with torch.no_grad():
            return net(x, torch.from_numpy(mu), t, torch.from_numpy(ty),
                       [torch.from_numpy(a) for a in text], None)[0]

    j, p = JaxIRSDE(T=100), IRSDE(T=100)
    x_T = (mu + j.max_sigma * rng.standard_normal(mu.shape)).astype(np.float32)
    want, calls = jax_ode_sampler(j, x_T, mu, fj)
    got, info = p.ode_sampler(torch.from_numpy(x_T), torch.from_numpy(mu), fp,
                              return_info=True)
    _close(got, want, ODE_TOL)
    # an error ratio within roundoff of 1 (the port reads 0.99875 where JAX
    # rejects) may flip one step: at most one step's 6 evaluations apart
    assert abs(info["nfev"] - calls) <= 6 and info["accepted"] > 0


# ---------------------------------------------------------------- degradations


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("shape,scale", [((2, 5, 7, 1), 4), ((1, 8, 6, 3), 2)])
def test_upscale_equals_jax(method, shape, scale):
    x = np.random.default_rng(11).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax_deg.upscale(jnp.asarray(x), scale, method))
    got = deg.upscale(torch.from_numpy(x), scale, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_upscale_bicubic_is_torch_bicubic():
    x = torch.from_numpy(np.random.default_rng(12).uniform(-1, 1, (1, 6, 5, 2)).astype(
        np.float32))
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=3,
                                           mode="bicubic", align_corners=False)
    torch.testing.assert_close(deg.upscale(x, 3), want.permute(0, 2, 3, 1), rtol=0, atol=1e-6)


def test_mask_to_equals_jax():
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    mask = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(deg.mask_to(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
                                  np.asarray(jax_deg.mask_to(jnp.asarray(x), jnp.asarray(mask))))


@pytest.mark.parametrize("looks", [1, 4])
def test_gamma_speckle_equals_jax(looks):
    x = np.random.default_rng(14).uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32)
    key = jax.random.key(15)
    want = np.asarray(jax_deg.add_speckle(key, jnp.asarray(x), looks=looks))
    draws = np.asarray(jax.random.gamma(key, looks, x.shape, dtype=jnp.float32))
    got = deg.add_speckle(torch.from_numpy(x), looks=looks, noise=torch.from_numpy(draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    g = deg.add_speckle(torch.from_numpy(x), looks=looks,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(g, deg.add_speckle(torch.from_numpy(x), looks=looks,
                                          generator=torch.Generator().manual_seed(1)))
    assert float(g.min()) >= -1.0 and float(g.max()) <= 1.0
