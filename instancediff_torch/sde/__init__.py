from .ddpm_sde import DDPMSDE, make_cosine_alphas_bar
from .drift_sde import DriftSDE
from .schedules import make_schedule, strided_sampling_grid


def create_sde(sde_opt):
    """The SDE of a ``sdes.<name>`` option block, keyed on its
    ``class_name`` with the JAX factory's defaults (``create_sde`` in
    ``instancediff_tpu/sde/__init__.py``)."""
    opt = dict(sde_opt)
    class_name = opt.pop("class_name")
    if class_name == "driftSDE":
        return DriftSDE(T=opt.get("T", 100), max_sigma=opt.get("max_sigma", 0.4),
                        drift_schedule=opt.get("drift_schedule", "sigmoid"),
                        noise_schedule=opt.get("noise_schedule", "sigmoid"),
                        eta=opt.get("eta", 1.0))
    if class_name == "DDPM":
        return DDPMSDE(T=opt.get("T", 100), max_sigma=opt.get("max_sigma", 1.0),
                       schedule=opt.get("schedule", "cosine_alpha"))
    if class_name == "IRSDE":
        raise NotImplementedError("IRSDE is not ported yet (ROADMAP queue 1 item 5)")
    raise ValueError(f"unknown SDE class '{class_name}' (have driftSDE, DDPM, IRSDE)")


__all__ = ["DDPMSDE", "DriftSDE", "create_sde", "make_cosine_alphas_bar", "make_schedule",
           "strided_sampling_grid"]
