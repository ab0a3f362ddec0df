"""Climatological thresholds for the binary and categorical metrics.

Counterpart of ``weatherbench2_tpu/thresholds.py``: a Threshold maps a truth
chunk to per-(time, space) threshold values, either from precomputed
climatological quantiles or from a Gaussian fit (mean + ppf(q)·std).  The
selection runs on the host, on the climatology's numpy (or lazy) payloads;
the engine moves the result to the device with the chunk.
"""
import collections
from collections import abc
import dataclasses
import threading
import typing

from scipy import stats

from weatherbench2_torch import xds

# truth chunks whose thresholds ``compute_cached`` keeps: about the chunks
# that the engine prepares at once
_CACHED_TRUTHS = 4


def _get_climatology_mean(
    climatology: xds.Dataset, variables: abc.Sequence[str]
) -> xds.Dataset:
  """The climatological mean of the given variables."""
  if all(v in climatology for v in variables):
    return climatology[list(variables)]
  clim_var_dict = {var + "_mean": var for var in variables}
  not_found = set(variables).difference(climatology.keys())
  not_found_means = set(clim_var_dict).difference(climatology.keys())
  if not_found and not_found_means:
    raise KeyError(
        f"climatology is missing variables {not_found} (neither bare "
        "names nor their '_mean'-suffixed forms are present)")
  return climatology[list(clim_var_dict.keys())].rename(clim_var_dict)


def _get_climatology_std(
    climatology: xds.Dataset, variables: abc.Sequence[str]
) -> xds.Dataset:
  """The climatological standard deviation of the given variables."""
  clim_std_dict = {key + "_std": key for key in variables}
  not_found = set(clim_std_dict).difference(climatology.keys())
  if not_found:
    raise KeyError(f"Did not find {not_found} keys in climatology.")
  return climatology[list(clim_std_dict.keys())].rename(clim_std_dict)


def _get_climatology_quantile(
    climatology: xds.Dataset,
    variables: abc.Sequence[str],
    quantile: typing.Union[abc.Sequence[float], float],
    atol: float = 0.01,
) -> xds.Dataset:
  """Climatological quantiles of the given variables."""
  clim_q_dict = {key + "_quantile": key for key in variables}
  not_found = set(clim_q_dict).difference(climatology.keys())
  if not_found:
    raise KeyError(f"Did not find {not_found} keys in climatology.")
  climatology_q = climatology[list(clim_q_dict.keys())].rename(clim_q_dict)
  try:
    return climatology_q.sel(quantile=quantile, method="nearest",
                             tolerance=atol)
  except KeyError as e:
    raise KeyError(
        f"no climatology quantile within {atol} of {quantile}; raise the "
        "tolerance or rebuild the climatology with these quantile levels"
    ) from e


def _select_climatology_at_times(
    climatology: xds.Dataset, truth: xds.Dataset
) -> xds.Dataset:
  """The climatology at the truth chunk's (dayofyear[, hour]) times."""
  time_dim = "time" if "time" in truth.sizes else "valid_time"
  climatology_chunk = climatology
  if "level" in truth.sizes and "level" in climatology.sizes:
    climatology_chunk = climatology_chunk.sel(level=truth["level"].values)
  time_selection = dict(dayofyear=truth[time_dim].dt.dayofyear)
  if "hour" in climatology_chunk.sizes:
    time_selection["hour"] = truth[time_dim].dt.hour
  return climatology_chunk.sel(time_selection)


@dataclasses.dataclass
class Threshold:
  """Threshold for discrete probabilistic metric evaluation.

  Attributes:
    climatology: Dataset describing the climatological distribution.
    quantile: The quantile to be evaluated.
  """

  climatology: xds.Dataset
  quantile: float

  def compute(self, truth: xds.Dataset) -> xds.Dataset:
    raise NotImplementedError

  def compute_cached(self, truth: xds.Dataset) -> xds.Dataset:
    """``compute(truth)``, kept for the last few truth objects.

    Every threshold metric of every config prepares the same truth chunk
    against the same thresholds (the CLI hands one list to all of them),
    and the climatology read is the costly part.  The slot holds the truth
    object, so that its id stays its own; the prefetch threads may call
    this at once.
    """
    lock = self.__dict__.setdefault("_cache_lock", threading.Lock())
    with lock:
      cache = self.__dict__.setdefault("_cache", collections.OrderedDict())
      hit = cache.get(id(truth))
      if hit is not None and hit[0] is truth:
        return hit[1]
    result = self.compute(truth)
    with lock:
      cache[id(truth)] = (truth, result)
      while len(cache) > _CACHED_TRUTHS:
        cache.popitem(last=False)
    return result


@dataclasses.dataclass
class QuantileThreshold(Threshold):
  """Quantile threshold from a precomputed `<var>_quantile` climatology."""

  def compute(self, truth: xds.Dataset) -> xds.Dataset:
    climatology_chunk = _select_climatology_at_times(self.climatology, truth)
    variables = [str(key) for key in truth.keys()]
    return _get_climatology_quantile(climatology_chunk, variables,
                                     self.quantile)


@dataclasses.dataclass
class GaussianQuantileThreshold(Threshold):
  """Gaussian quantile threshold: mean + ppf(quantile) * std."""

  def compute(self, truth: xds.Dataset) -> xds.Dataset:
    climatology_chunk = _select_climatology_at_times(self.climatology, truth)
    variables = [str(key) for key in truth.keys()]
    climatology_mean = _get_climatology_mean(climatology_chunk, variables)
    climatology_std = _get_climatology_std(climatology_chunk, variables)
    return climatology_mean + float(stats.norm.ppf(self.quantile)) * (
        climatology_std)


def get_threshold_cls(threshold_method: str) -> type:
  """The threshold class for the given threshold method."""
  if threshold_method == "quantile":
    return QuantileThreshold
  if threshold_method == "gaussian_quantile":
    return GaussianQuantileThreshold
  raise NotImplementedError(f"Unknown threshold method: {threshold_method}")
