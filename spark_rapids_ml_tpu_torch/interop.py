"""Carrying fitted models from the JAX package into the port.

A JAX model is its attributes (numpy arrays and scalars) plus its Params;
the port's model of the same name takes both unchanged. Two ways in:

* :func:`from_jax_attributes` — attributes and params already in hand
  (for example ``model._model_attributes`` and the set params of a JAX
  model in the same process, moved as numpy);
* :func:`load_jax_model` — a directory the JAX package saved
  (``metadata.json``, ``model.npz``, ``attributes.json``).

Neither imports the JAX package: class names map onto the port's classes
through ``core._JAX_CLASSES``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from .core import _JAX_CLASSES, _Reader, _TpuModel, resolve_class


def from_jax_attributes(
    cls_name: str,
    attrs: Mapping[str, Any],
    params: Optional[Mapping[str, Any]] = None,
    *,
    device: Optional[str] = None,
) -> _TpuModel:
    """The port's model ``cls_name`` (``"PCAModel"``, ``"KMeansModel"``,
    ``"LogisticRegressionModel"``, ``"LinearRegressionModel"``,
    ``"UMAPModel"``, or a JAX package's full class path)
    built from a JAX model's attributes and Params (name -> value)."""
    full = cls_name
    if "." not in cls_name:
        matches = [k for k in _JAX_CLASSES if k.rsplit(".", 1)[1] == cls_name]
        if not matches:
            raise ValueError(f"no ported model named {cls_name!r}")
        full = matches[0]
    cls = resolve_class(full)
    if not issubclass(cls, _TpuModel):
        raise ValueError(f"{cls_name!r} is not a model class")
    model = cls(**dict(attrs))
    mapping = model._param_mapping()
    for p, v in (params or {}).items():
        name = getattr(p, "name", p)  # a Param object or its name
        if model.hasParam(name):
            model._set(**{name: v})
            # the backend copy that fit-time settings are read from
            # (UMAP's transform reads n_neighbors, random_state, ... there)
            if mapping.get(name):
                model._tpu_params[mapping[name]] = v
    model._device = device
    return model


def load_jax_model(path: str, *, device: Optional[str] = None) -> _TpuModel:
    """Load a model directory saved by the JAX package (its
    ``_Writer`` format) as the port's model, on ``device``."""
    inst = _Reader(_TpuModel).load(path)
    if not isinstance(inst, _TpuModel):
        raise ValueError(f"{path!r} holds an estimator, not a fitted model")
    inst._device = device
    return inst

