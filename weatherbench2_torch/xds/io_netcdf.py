"""NetCDF3 (scipy) IO for the port's results files.

The port's machines have no h5py, so results are written in the classic
format with ``scipy.io.netcdf_file``; ``weatherbench2_tpu.xds.open_netcdf``
sniffs the format and reads them.  Datetimes/timedeltas are CF-encoded as
float64 microseconds (NetCDF3 has no int64), strings as char arrays with a
``<name>_strlen`` dimension.
"""
from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from . import core
from .io_zarr import KNOWN_COORD_NAMES, decode_cf, encode_cf, merged_cf_attrs


def to_netcdf(ds: core.Dataset, path: str) -> None:
  """Write a Dataset to a NetCDF3 file."""
  all_vars: dict[str, core.Variable] = {}
  all_vars.update(ds.coords_dict())
  all_vars.update(ds.variables_dict())
  with netcdf_file(path, "w") as f:
    values_of = {name: core._to_numpy(var.data)
                 for name, var in all_vars.items()}
    for dim, size in ds.sizes.items():
      f.createDimension(dim, size)
    for name, values in values_of.items():
      if values.dtype.kind in ("U", "O", "S"):
        maxlen = max((len(str(s).encode()) for s in values.ravel()),
                     default=1)
        f.createDimension(f"{name}_strlen", max(maxlen, 1))

    for name, var in all_vars.items():
      values = values_of[name]
      if values.dtype.kind in ("U", "O", "S"):
        strlen = f.dimensions[f"{name}_strlen"]
        chars = np.zeros(values.shape + (strlen,), dtype="S1")
        cview = chars.reshape(-1, strlen)
        for i, s in enumerate(values.ravel()):
          b = str(s).encode("utf-8")[:strlen]
          cview[i, :len(b)] = np.frombuffer(b, dtype="S1")
        v = f.createVariable(name, "c", tuple(var.dims) + (f"{name}_strlen",))
        v[:] = chars
        v._xds_string = 1
        continue
      data, cf_attrs = encode_cf(values)
      if data.dtype == np.int64:
        if "units" in cf_attrs:
          # microseconds stay exact in float64 for any realistic time
          data = (data // 1000).astype(np.float64)
          cf_attrs = {k: v.replace("nanoseconds", "microseconds")
                      for k, v in cf_attrs.items()}
        elif data.size and np.abs(data).max() < 2**31:
          data = data.astype(np.int32)  # NetCDF3 has no int64
        else:
          data = data.astype(np.float64)
      if data.dtype == np.bool_:
        data = data.astype(np.int8)
      v = f.createVariable(name, data.dtype.newbyteorder(">"), var.dims)
      if data.ndim:
        v[:] = data
      else:
        v.data[()] = data.item()
      for k, val in merged_cf_attrs(var.attrs, cf_attrs).items():
        if isinstance(val, str):
          setattr(v, k, val)
    for k, val in ds.attrs.items():
      if isinstance(val, (str, int, float)):
        setattr(f, k, val)


# The first bytes of a NetCDF4 file: it is an HDF5 file.
_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def open_netcdf(path: str) -> core.Dataset:
  """Read a NetCDF3 file written by ``to_netcdf``.  A NetCDF4 (HDF5) file,
  what the JAX package writes by default, is refused by name: reading it
  needs h5py, which the port does without."""
  with open(path, "rb") as f:
    if f.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE:
      raise ValueError(
          f"{path} is a NetCDF4/HDF5 file; the port reads NetCDF3 only "
          "(write results in NetCDF3, e.g. with weatherbench2_torch.xds."
          "to_netcdf, or as Zarr)")
  with netcdf_file(path, "r", mmap=False) as f:
    variables: dict[str, core.Variable] = {}
    for name, v in f.variables.items():
      attrs = {k: (val.decode() if isinstance(val, bytes) else val)
               for k, val in v._attributes.items()}
      data = np.array(v.data)
      data = data.astype(data.dtype.newbyteorder("="))
      dims = tuple(v.dimensions)
      if attrs.pop("_xds_string", None) or (
          data.dtype.kind == "S" and dims and dims[-1].endswith("_strlen")):
        strings = np.array(
            [b"".join(row).decode("utf-8").rstrip("\x00")
             for row in data.reshape(-1, data.shape[-1])],
            dtype=object,
        ).reshape(data.shape[:-1])
        variables[name] = core.Variable(dims[:-1], strings)
        continue
      units = attrs.get("units", "")
      if isinstance(units, str) and (
          "since" in units or units in ("microseconds", "nanoseconds",
                                        "seconds", "hours", "days")):
        decoded = decode_cf(data.astype(np.int64), attrs)
        if decoded.dtype != data.dtype:
          data = decoded
          attrs.pop("units", None)
          attrs.pop("calendar", None)
      variables[name] = core.Variable(dims, data, attrs)
    dim_names = set(f.dimensions)
    attrs = {k: (val.decode() if isinstance(val, bytes) else val)
             for k, val in f._attributes.items()}
  coords, data_vars = {}, {}
  for name, v in variables.items():
    is_coord = name in dim_names or name in KNOWN_COORD_NAMES
    (coords if is_coord else data_vars)[name] = v
  return core.Dataset(data_vars, coords=coords, attrs=attrs)
