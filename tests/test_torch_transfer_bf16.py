"""The bfloat16 transfer mode (``WB2_TRANSFER_DTYPE=bfloat16``) of the port.

The rule is the JAX package's (``weatherbench2_tpu/parallel/streaming.py``,
``_to_device``): a host float32 or float64 payload of more than 4096
entries crosses as bfloat16 and becomes float32 on the device; smaller
ones, other types and tensors cross as they are.  The host cast is held
bit for bit to ``ml_dtypes`` (the JAX package's cast), on values on and
next to a rounding tie: ``ml_dtypes`` rounds float64 through float32 (two
roundings to nearest even), and so does the port.  NaN becomes the quiet
NaN of its sign, as in ``ml_dtypes``.

The mode is lossy, so the port's bfloat16 run is held to the JAX package's
bfloat16 run on the same stores, not to the float32 results, with the
tolerance of ``tests/test_torch_evaluation.py``: ``rtol=1e-5`` plus
``atol=1e-5 x max|reference|`` per variable (both score the same bfloat16
inputs; the port sums in float32, the JAX run here in float64).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from weatherbench2_tpu import config as jconfig
from weatherbench2_tpu import derived_variables as jdv
from weatherbench2_tpu import evaluation as jevaluation
from weatherbench2_tpu import metrics as jmetrics
from weatherbench2_tpu import schema as jschema
from weatherbench2_tpu import utils as jutils
from weatherbench2_tpu import xds as jxds
from weatherbench2_tpu.regions import ExtraTropicalRegion, SliceRegion
from weatherbench2_torch import convert
from weatherbench2_torch import evaluation
from weatherbench2_torch import xds
from weatherbench2_torch.xds import stream

RTOL = 1e-5
WIND = ["u_component_of_wind", "v_component_of_wind"]


def _ties(dtype):
  """Values on, just below and just above a bfloat16 rounding tie (both
  parities of the kept bit), NaN of both signs, infinities, the largest
  finite values, subnormals; for float64 also ties that only float64
  breaks (the double rounding through float32)."""
  base = np.array([1.0, 1.0078125, -3.5, 1e-3, 6.02e23, 1e-39],
                  np.float64)
  ulp = np.float64(2.0) ** (np.floor(np.log2(np.abs(base))) - 7)
  half = ulp / 2
  vals = [base, base + half, base - half, base + 3 * half,
          np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                    3.3895313892515355e38, -3.4028234663852886e38,
                    1e-45, -1.4e-45])]
  if dtype == np.float64:
    tiny = half * 2.0 ** -30
    vals += [base + half + tiny, base + half - tiny, base + 3 * half - tiny]
  x = np.concatenate(vals).astype(dtype)
  rng = np.random.default_rng(0)
  random = rng.standard_normal(4000) * 10.0 ** rng.integers(-40, 39, 4000)
  return np.concatenate([x, random.astype(dtype)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cast_matches_ml_dtypes_bit_for_bit(dtype):
  x = _ties(dtype)
  with np.errstate(over="ignore", invalid="ignore"):
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
  got = stream.bfloat16_bits(x)
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                want)


def test_float64_ties_round_through_float32_as_ml_dtypes_does():
  """1 + 2^-8 + 2^-30 rounds up to bfloat16 directly but to 1 through
  float32: ml_dtypes gives 1, and so does the port."""
  x = np.array([1 + 2.0 ** -8 + 2.0 ** -30])
  assert x.astype(ml_dtypes.bfloat16).astype(np.float64)[0] == 1.0
  assert stream.bfloat16_bits(x).to(torch.float64).item() == 1.0


def test_to_device_narrows_only_large_float_host_payloads():
  """More than 4096 float entries: bfloat16 bytes counted, float32 back;
  4096 entries, integers and tensors cross as they are."""
  big = np.linspace(-3, 3, 4097)
  small = np.linspace(-3, 3, 4096).astype(np.float32)
  ints = np.arange(5000)
  tensor = torch.linspace(0, 1, 5000, dtype=torch.float64)
  obj = {"big": xds.DataArray(big, dims=("x",)),
         "small": xds.DataArray(small, dims=("y",)),
         "ints": xds.DataArray(ints, dims=("z",)),
         "tensor": xds.DataArray(tensor, dims=("z",))}
  counter = {}
  out = xds.to_device(obj, torch.device("cpu"), counter=counter,
                      transfer_dtype=torch.bfloat16)
  assert out["big"].data.dtype == torch.float32
  np.testing.assert_array_equal(
      out["big"].data.numpy(),
      big.astype(ml_dtypes.bfloat16).astype(np.float32))
  assert out["small"].data.dtype == torch.float32
  np.testing.assert_array_equal(out["small"].data.numpy(), small)
  assert out["ints"].data.dtype == torch.int64
  assert out["tensor"].data is tensor
  assert counter["h2d_bytes"] == 4097 * 2 + 4096 * 4 + 5000 * 8


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  """Float32 stores at 10 degrees (684 cells a field, so every chunk's
  payloads cross the 4096-entry rule), written uncompressed."""
  tmp = tmp_path_factory.mktemp("torch_bf16")
  kw = dict(variables_3d=["geopotential"], variables_2d=["2m_temperature"],
            time_start="2020-01-01", spatial_resolution_in_degrees=10.0)
  wind = dict(kw, variables_3d=["geopotential", *WIND])
  as32 = lambda ds: ds.copy(data={k: np.asarray(v.data, np.float32)
                                  for k, v in ds.variables_dict().items()})
  data = {
      "truth": jschema.mock_truth_data(time_stop="2020-01-15", **wind),
      "forecast": jschema.mock_forecast_data(lead_stop="2 days",
                                             time_stop="2020-01-06", **wind),
      "ensemble": jschema.mock_forecast_data(lead_stop="2 days",
                                             time_stop="2020-01-06",
                                             ensemble_size=4, **kw),
      "climatology": jschema.mock_hourly_climatology_data(
          variables_3d=["geopotential"], variables_2d=["2m_temperature"],
          spatial_resolution_in_degrees=10.0, hour_interval=6)}
  paths = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("WB2_ZARR_COMPRESSOR", "none")
    for seed, (name, ds) in enumerate(data.items()):
      paths[name] = str(tmp / f"{name}.zarr")
      jxds.to_zarr(as32(jutils.random_like(ds, seed=seed)), paths[name])
  return tmp, paths


def _configs(paths, which):
  regions = {"global": SliceRegion(), "extra-tropics": ExtraTropicalRegion()}
  if which == "probabilistic":
    return {"prob": jconfig.Eval(
        metrics={"crps": jmetrics.CRPS(),
                 "ensemble_mean_mse": jmetrics.EnsembleMeanMSE()},
        regions=regions)}
  if which == "derived":
    return {"derived": jconfig.Eval(
        metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias(),
                 "rmse": jmetrics.RMSESqrtBeforeTimeAvg()},
        regions=regions, derived_variables={
            "wind_speed": jdv.DERIVED_VARIABLE_DICT["wind_speed"]})}
  clim = jxds.open_zarr(paths["climatology"])
  return {"det": jconfig.Eval(
      metrics={"mse": jmetrics.MSE(), "bias": jmetrics.Bias(),
               "rmse": jmetrics.RMSESqrtBeforeTimeAvg(),
               "acc": jmetrics.ACC(climatology=clim)},
      regions=regions)}


def _data_config(paths, which, out_dir):
  return jconfig.Data(
      selection=jconfig.Selection(
          variables=["geopotential", "2m_temperature"], levels=[500, 850],
          time_slice=slice("2020-01-01", "2020-01-05")),
      paths=jconfig.Paths(
          forecast=paths["ensemble" if which == "probabilistic"
                         else "forecast"],
          obs=paths["truth"], climatology=paths["climatology"],
          output_dir=str(out_dir)),
      by_init=True)


@pytest.mark.parametrize("which", ["deterministic", "probabilistic",
                                   "derived"])
def test_port_bfloat16_run_matches_the_jax_bfloat16_run(stores, which,
                                                        monkeypatch):
  tmp, paths = stores
  cfgs = _configs(paths, which)
  name = next(iter(cfgs))
  chunks = {"init_time": 2}
  runs, stats = {}, {}
  for mode in ("", "bfloat16"):
    monkeypatch.setenv("WB2_TRANSFER_DTYPE", mode)
    out = tmp / f"{which}_port_{mode or 'float32'}"
    stats[mode] = evaluation.evaluate_with_mesh(
        convert.from_reference(_data_config(paths, which, out)),
        convert.eval_configs_from_reference(cfgs), device="cpu",
        input_chunks=chunks)
    runs[mode] = jxds.open_netcdf(str(out / f"{name}.nc"))
  jout = tmp / f"{which}_jax_bfloat16"
  jevaluation.evaluate_with_mesh(_data_config(paths, which, jout), cfgs,
                                 input_chunks=chunks)
  want = jxds.open_netcdf(str(jout / f"{name}.nc"))
  got = runs["bfloat16"]
  lossy = 0.0
  for k in want.keys():
    w = np.asarray(want[k].values, np.float64)
    g = np.asarray(got[k].transpose(*want[k].dims).values, np.float64)
    np.testing.assert_allclose(g, w, rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(w)), err_msg=k)
    f32 = np.asarray(runs[""][k].transpose(*want[k].dims).values)
    lossy = max(lossy, np.nanmax(np.abs(g - f32)) / np.nanmax(np.abs(f32)))
  # the mode is lossy: about three significant digits of the inputs
  assert 1e-5 < lossy < 1e-2
  # the forecast and truth payloads cross at half their float32 bytes, but
  # for the base fields of a derived variable (u and v at two levels, 4 of
  # the 7 fields of the derived config: (4 + 3 / 2) / 7 of the bytes)
  ratio = stats["bfloat16"]["h2d_bytes"] / stats[""]["h2d_bytes"]
  low, high = (0.75, 0.85) if which == "derived" else (0.5, 0.6)
  assert low <= ratio < high, ratio


def test_unknown_transfer_dtype_is_refused(stores, monkeypatch):
  tmp, paths = stores
  monkeypatch.setenv("WB2_TRANSFER_DTYPE", "float16")
  cfgs = _configs(paths, "deterministic")
  with pytest.raises(ValueError, match="WB2_TRANSFER_DTYPE='float16'"):
    evaluation.evaluate_with_mesh(
        convert.from_reference(_data_config(paths, "deterministic",
                                            tmp / "refused")),
        convert.eval_configs_from_reference(cfgs), device="cpu")


def test_full_precision_fields_cross_as_they_are_and_round_later():
  """The base fields of a derived variable cross in their own type; the
  rounding on the device then gives the host cast's values, NaN kept."""
  x = np.tile(_ties(np.float64), 2)  # past the 4096 entries of the rule
  ds = xds.Dataset({"u": xds.DataArray(x, dims=("x",)),
                    "z": xds.DataArray(x.astype(np.float32), dims=("x",))})
  counter = {}
  with np.errstate(over="ignore", invalid="ignore"):
    moved = xds.to_device(ds, torch.device("cpu"), counter=counter,
                          transfer_dtype=torch.bfloat16,
                          full_precision={"u"})
  assert moved["u"].data.dtype == torch.float64
  np.testing.assert_array_equal(moved["u"].data.numpy(), x)
  assert counter["h2d_bytes"] == x.size * (8 + 2)
  rounded = xds.round_to_bfloat16((moved,))[0]
  for name, host in (("u", x), ("z", x.astype(np.float32))):
    want = stream.bfloat16_bits(host).to(torch.float32).numpy()
    assert rounded[name].data.dtype == torch.float32
    np.testing.assert_array_equal(rounded[name].data.numpy(), want)
