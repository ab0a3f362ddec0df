"""xds: minimal labeled arrays for the PyTorch port (xarray-free)."""
from .core import (
    DataArray,
    Dataset,
    Index,
    Variable,
    align_arrays,
    broadcast_dims_order,
    broadcast_variables,
    concat,
    merge,
    where,
    zeros_like,
)
from .io_netcdf import open_netcdf, to_netcdf
from .io_zarr import (create_zarr_template, open_zarr, to_zarr,
                      write_zarr_region)
from .stream import (RegionWriter, ShapeStub, default_block, iter_windows,
                     read, stub_variable, template_dataset, to_device)

__all__ = [
    "DataArray",
    "Dataset",
    "Index",
    "Variable",
    "align_arrays",
    "broadcast_dims_order",
    "broadcast_variables",
    "concat",
    "merge",
    "open_netcdf",
    "to_netcdf",
    "open_zarr",
    "to_zarr",
    "create_zarr_template",
    "RegionWriter",
    "ShapeStub",
    "default_block",
    "iter_windows",
    "read",
    "stub_variable",
    "template_dataset",
    "to_device",
    "where",
    "write_zarr_region",
    "zeros_like",
]
