"""Test helpers: monotonicity asserts and NaN injection.

Counterpart of ``weatherbench2_tpu/test_utils.py`` on the port's labeled
arrays (numpy or tensor payloads).
"""
import numpy as np

from weatherbench2_torch import xds
from weatherbench2_torch.xds import _xp


def _values(x):
  if isinstance(x, xds.DataArray):
    return x.values
  return _xp.to_numpy(x)


def assert_strictly_increasing(x, axis=-1, err_msg=""):
  if not (np.diff(_values(x), axis=axis) > 0).all():
    raise AssertionError(f"array not strictly increasing: {err_msg}")


def assert_strictly_decreasing(x, axis=-1, err_msg=""):
  if not (np.diff(_values(x), axis=axis) < 0).all():
    raise AssertionError(f"array not strictly decreasing: {err_msg}")


def assert_positive(x, err_msg=""):
  if not (_values(x) > 0).all():
    raise AssertionError(f"array not positive: {err_msg}")


def assert_negative(x, err_msg=""):
  if not (_values(x) < 0).all():
    raise AssertionError(f"array not negative: {err_msg}")


def insert_nan(dataset: xds.Dataset, frac_nan: float = 0.1,
               seed: int = 802701) -> xds.Dataset:
  """Replace a random fraction of each variable's values with NaN.

  The mask is drawn from ``np.random.RandomState(seed)`` in variable order,
  as the JAX package draws it (the default seed is the reference's), so
  both packages put NaN in the same cells; the payloads come back as numpy
  arrays, float payloads in their own float type.
  """
  rs = np.random.RandomState(seed)
  new_data = {}
  for k, v in dataset.variables_dict().items():
    values = _xp.to_numpy(v.data)
    mask = rs.rand(*values.shape) < frac_nan
    new_data[k] = np.where(mask, np.nan, values)
  return dataset.copy(data=new_data)
