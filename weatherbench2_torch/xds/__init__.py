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
    where,
    zeros_like,
)
from .io_netcdf import open_netcdf, to_netcdf
from .io_zarr import create_zarr_template, open_zarr, to_zarr
from .stream import (RegionWriter, ShapeStub, default_block, iter_windows,
                     stub_variable, template_dataset, to_device)

__all__ = [
    "DataArray",
    "Dataset",
    "Index",
    "Variable",
    "align_arrays",
    "broadcast_dims_order",
    "broadcast_variables",
    "concat",
    "open_netcdf",
    "to_netcdf",
    "open_zarr",
    "to_zarr",
    "create_zarr_template",
    "RegionWriter",
    "ShapeStub",
    "default_block",
    "iter_windows",
    "stub_variable",
    "template_dataset",
    "to_device",
    "where",
    "zeros_like",
]
