"""Models of the sampler path: CLIP text tower, score map modules, the UNet
and the sampling engines (drift and DDPM), with the config factory
``create_model`` (port of ``instancediff_tpu/models/__init__.py``)."""

import importlib


def create_model(train_opt, model_opt, phase="train", **kwargs):
    """The engine a ``models.<name>`` option block names: its
    ``module_name`` (a module of this package) and ``class_name``
    (``create_<class_name>`` there), as the JAX factory dispatches."""
    module = importlib.import_module(f"{__package__}.{model_opt['module_name']}")
    factory = getattr(module, f"create_{model_opt['class_name']}")
    return factory(train_opt, model_opt, phase=phase, **kwargs)
