"""State carried across from the JAX package: configs and data.

A verification run has no weights, but its parameters must still be the
same on both sides: the config objects (metrics, regions, thresholds,
selections) and the data.  ``eval_configs_from_reference`` maps the
reference package's dataclasses (derived variables included) onto the
port's by class name and dataclass fields, without importing that package;
labeled payloads (an ACC climatology, a LandRegion mask) cross as numpy
arrays into the port's ``xds``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from weatherbench2_torch import (config, derived_variables, metrics, regions,
                                 thresholds, xds)

_PORT_CLASSES = {
    cls.__name__: cls
    for module in (config, derived_variables, metrics, regions, thresholds)
    for cls in vars(module).values()
    if isinstance(cls, type) and dataclasses.is_dataclass(cls)
    and cls.__module__ == module.__name__
}


def _is_port(obj) -> bool:
  return type(obj).__module__.startswith("weatherbench2_torch")


def _labeled(obj):
  """A reference xds Variable/DataArray/Dataset as the port's."""
  kind = type(obj).__name__
  if kind == "Variable":
    return xds.Variable(obj.dims, np.asarray(obj.data), dict(obj.attrs))
  if kind == "DataArray":
    return xds.DataArray(
        _labeled(obj.variable),
        coords={k: _labeled(v) for k, v in obj.coords.items()},
        name=obj.name)
  return xds.Dataset(
      {k: _labeled(v) for k, v in obj.variables_dict().items()},
      coords={k: _labeled(v) for k, v in obj.coords_dict().items()},
      attrs=dict(obj.attrs))


def _convert(obj):
  if _is_port(obj) or obj is None or isinstance(
      obj, (str, int, float, bool, slice, np.ndarray, np.generic)):
    return obj
  if isinstance(obj, dict):
    return {k: _convert(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return type(obj)(_convert(v) for v in obj)
  if type(obj).__name__ in ("Variable", "DataArray", "Dataset"):
    return _labeled(obj)
  if dataclasses.is_dataclass(obj):
    name = type(obj).__name__
    cls = _PORT_CLASSES.get(name)
    if cls is None:
      raise NotImplementedError(
          f"{type(obj).__module__}.{name} has no counterpart in the port "
          "yet (see ROADMAP)")
    port_fields = {f.name for f in dataclasses.fields(cls) if f.init}
    kwargs = {}
    for f in dataclasses.fields(obj):
      if not f.init:
        continue
      value = getattr(obj, f.name)
      if f.name not in port_fields:
        raise NotImplementedError(
            f"{name}.{f.name} has no counterpart in the port")
      kwargs[f.name] = _convert(value)
    # what a class keeps outside its fields (RankHistogram's seed, bins)
    for arg, attr in getattr(cls, "init_attributes", {}).items():
      kwargs[arg] = _convert(getattr(obj, attr))
    return cls(**kwargs)
  raise TypeError(f"cannot convert {type(obj).__module__}."
                  f"{type(obj).__name__} to the port")


def eval_configs_from_reference(eval_configs: Mapping[str, Any]) -> dict:
  """{name: reference config.Eval} → {name: port config.Eval}."""
  return {name: _convert(cfg) for name, cfg in eval_configs.items()}


def from_reference(obj):
  """One reference config, Selection/Paths/Data, metric or region."""
  return _convert(obj)


def state_from_reference(state):
  """A ``StreamingState`` of the reference package (already unpickled, its
  payloads numpy) as the port's, so that the port can resume a run that
  the reference package began: the same fields, labeled objects crossing
  as in ``from_reference``."""
  from weatherbench2_torch.parallel import streaming

  fields = {f.name: getattr(state, f.name)
            for f in dataclasses.fields(streaming.StreamingState)}
  return streaming.StreamingState(**{
      k: _convert(v) if k in ("sums", "counts", "configs", "completed_leads")
      else v for k, v in fields.items()})


def dataset_from_arrays(variables: Mapping[str, tuple],
                        coords: Mapping[str, Any],
                        attrs: Mapping[str, Any] | None = None
                        ) -> xds.Dataset:
  """A port Dataset from numpy arrays.

  Args:
    variables: {name: (dims, array)}.
    coords: {name: array (1-d, on the dim of that name) or (dims, array)}.
    attrs: dataset attributes.
  """
  return xds.Dataset(
      {k: xds.Variable(dims, np.asarray(a)) for k, (dims, a) in
       variables.items()},
      coords={k: (xds.Variable(v[0], np.asarray(v[1]))
                  if isinstance(v, tuple) else np.asarray(v))
              for k, v in coords.items()},
      attrs=attrs,
  )


def grid_from_reference(grid):
  """A reference ``regridding.Grid`` as the port's: the same numpy
  coordinates and flags."""
  from weatherbench2_torch import regridding

  return regridding.Grid(
      longitudes=np.asarray(grid.longitudes),
      latitudes=np.asarray(grid.latitudes),
      periodic=bool(grid.periodic), includes_poles=bool(grid.includes_poles))


def regridder_from_reference(regridder):
  """A reference ``Regridder`` (nearest, bilinear or conservative) as the
  port's, by class name, between the same grids."""
  from weatherbench2_torch import regridding

  cls = getattr(regridding, type(regridder).__name__, None)
  if not (isinstance(cls, type) and issubclass(cls, regridding.Regridder)):
    raise NotImplementedError(
        f"{type(regridder).__name__} has no counterpart in the port")
  return cls(grid_from_reference(regridder.source),
             grid_from_reference(regridder.target))
