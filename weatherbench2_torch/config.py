"""Configuration dataclasses for the port's evaluation engine.

The fields match ``weatherbench2_tpu/config.py`` (and so the reference
WeatherBench 2 config API), so configs translate one to one
(``convert.eval_configs_from_reference``).
"""
import dataclasses
import typing as t

from weatherbench2_torch.derived_variables import DerivedVariable
from weatherbench2_torch.metrics import Metric
from weatherbench2_torch.regions import Region


@dataclasses.dataclass
class Selection:
  """Subset of forecast/truth data to evaluate (see the JAX package)."""

  variables: t.Sequence[str]
  time_slice: slice
  levels: t.Optional[t.Sequence[int]] = None
  lat_slice: t.Optional[slice] = dataclasses.field(
      default_factory=lambda: slice(None, None)
  )
  lon_slice: t.Optional[slice] = dataclasses.field(
      default_factory=lambda: slice(None, None)
  )
  aux_variables: t.Optional[t.Sequence[str]] = None


@dataclasses.dataclass
class Paths:
  """Zarr input locations and the results output directory."""

  forecast: str
  obs: str
  output_dir: str
  output_file_prefix: t.Optional[str] = ""
  climatology: t.Optional[str] = None


@dataclasses.dataclass
class Data:
  """A Selection with Paths plus forecast-format switches."""

  selection: Selection
  paths: Paths
  by_init: t.Optional[bool] = True
  rename_variables: t.Optional[t.Dict[str, str]] = None
  pressure_level_suffixes: t.Optional[bool] = False


@dataclasses.dataclass
class Eval:
  """One evaluation job: the metric set and how to run it."""

  metrics: t.Dict[str, Metric]
  regions: t.Optional[t.Dict[str, Region]] = None
  evaluate_persistence: t.Optional[bool] = False
  evaluate_climatology: t.Optional[bool] = False
  evaluate_probabilistic_climatology: t.Optional[bool] = False
  probabilistic_climatology_start_year: t.Optional[int] = None
  probabilistic_climatology_end_year: t.Optional[int] = None
  probabilistic_climatology_hour_interval: t.Optional[int] = None
  against_analysis: t.Optional[bool] = False
  derived_variables: t.Dict[str, DerivedVariable] = dataclasses.field(
      default_factory=dict
  )
  temporal_mean: t.Optional[bool] = True
  output_format: str = "netcdf"

  def validate(self) -> None:
    """Raise on inconsistent settings."""
    if self.evaluate_probabilistic_climatology and (
        self.probabilistic_climatology_start_year is None
        or self.probabilistic_climatology_end_year is None):
      raise ValueError(
          "probabilistic climatology requires start and end years")
    if self.output_format not in ("netcdf", "zarr"):
      raise ValueError(f"unrecognized output_format {self.output_format!r}")


@dataclasses.dataclass
class Viz:
  """Visualization job configuration (see ``visualization.py``)."""

  results: t.Dict[str, str]
  save_kwargs: t.Dict[str, t.Any] = dataclasses.field(default_factory=dict)
  colors: t.Optional[t.Dict[str, str]] = None
  layout: t.Optional[t.Tuple[int, int]] = None
  figsize: t.Optional[t.Tuple[int, int]] = None
  tight_layout: t.Optional[bool] = True
  labels: t.Optional[t.Dict[str, str]] = None
  linestyles: t.Optional[t.Dict[str, str]] = None
  marker: t.Optional[str] = None
  markersize: t.Optional[int] = None


@dataclasses.dataclass
class Panel:
  """One panel of a timeseries figure: what to plot and how to label it."""

  metric: str
  variable: str
  level: t.Optional[int] = None
  region: t.Optional[str] = None
  relative: t.Optional[str] = None
  title: t.Optional[str] = None
  xlabel: t.Optional[str] = None
  ylabel: t.Optional[str] = None
  ylim: t.Optional[tuple] = None
  xlim: t.Optional[tuple] = None
