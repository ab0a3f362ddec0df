r"""Run the WeatherBench-2-compatible evaluation pipeline on a CUDA card.

The twin of ``scripts/evaluate.py`` (the JAX package's CLI): the same flag
names and defaults, the same predefined regions and eval-config names,
plus ``--device``.  It runs on the card unless ``--device=cpu`` is given;
without a card it raises.

Example:
  python -m weatherbench2_torch.cli.evaluate \
    --forecast_path=/data/forecast.zarr \
    --obs_path=/data/era5.zarr \
    --climatology_path=/data/climatology.zarr \
    --output_dir=/data/evals/ \
    --input_chunks=init_time=64 \
    --eval_configs=deterministic \
    --regions=all \
    --use_mesh

All twelve eval configs of the reference CLI: the four deterministic ones
(``deterministic``, ``deterministic_spatial``, ``deterministic_temporal``,
``deterministic_vs_analysis``), with wind-vector errors and
``--compute_seeps``, and the eight probabilistic ones (``probabilistic``,
``ensemble_binary``, ``ensemble_forecast_vs_era_experimental_metrics``,
``probabilistic_spatial``, ``ensemble_binary_spatial``,
``probabilistic_spatial_histograms``, ``gaussian_probabilistic``,
``gaussian_binary``), with ``--ensemble_dim`` and the thresholds of
``--quantile_thresholds``/``--threshold_method``; the derived variables of
``--derived_variables``; the persistence, climatology and probabilistic
climatology baselines; checkpoint/resume.  ``--n_devices`` raises and names
the ROADMAP item that will bring it.
"""
import argparse
import ast

import numpy as np

from weatherbench2_torch import config
from weatherbench2_torch import evaluation
from weatherbench2_torch import flag_utils
from weatherbench2_torch import metrics
from weatherbench2_torch import thresholds
from weatherbench2_torch import xds
from weatherbench2_torch.derived_variables import DERIVED_VARIABLE_DICT
from weatherbench2_torch.regions import CombinedRegion, LandRegion, SliceRegion

_DEFAULT_VARIABLES = [
    "geopotential",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "specific_humidity",
    "2m_temperature",
    "mean_sea_level_pressure",
]

_WIND_PAIRS = [
    ("u_component_of_wind", "v_component_of_wind", "wind_vector"),
    ("10m_u_component_of_wind", "10m_v_component_of_wind",
     "10m_wind_vector"),
    ("u_component_of_geostrophic_wind", "v_component_of_geostrophic_wind",
     "geostrophic_wind_vector"),
    ("u_component_of_ageostrophic_wind",
     "v_component_of_ageostrophic_wind", "ageostrophic_wind_vector"),
]


def build_parser() -> argparse.ArgumentParser:
  """The flags of ``scripts/evaluate.py`` with their defaults, and
  ``--device``.  Booleans take ``--flag``, ``--flag=false`` or
  ``--noflag``; lists are comma-separated."""
  f = flag_utils.Flags("python -m weatherbench2_torch.cli.evaluate",
                       __doc__)
  string, integer, boolean, listing = f.string, f.integer, f.boolean, f.listing

  string("forecast_path", None, "Path to forecast Zarr store")
  string("obs_path", None, "Path to ground-truth Zarr store")
  string("climatology_path", None, "Path to climatology (for ACC etc.)")
  boolean("by_init", True, "Forecasts in by-init (vs by-valid) format.")
  boolean("evaluate_persistence", False, "Evaluate persistence forecast.")
  boolean("evaluate_climatology", False, "Evaluate climatology forecast.")
  boolean("evaluate_probabilistic_climatology", False,
          "Evaluate probabilistic climatology (years as ensemble).")
  integer("probabilistic_climatology_start_year", None,
          "First ground-truth year for probabilistic climatology")
  integer("probabilistic_climatology_end_year", None,
          "Last ground-truth year for probabilistic climatology")
  integer("probabilistic_climatology_hour_interval", 6,
          "Hour interval for probabilistic climatology")
  listing("regions", None,
          'Predefined regions to evaluate ("all" for all of them).')
  string("lsm_dataset", None,
         "Dataset with land_sea_mask (defaults to obs dataset).")
  boolean("compute_seeps", False, "Compute SEEPS for precipitation.")
  string("eval_configs", "deterministic",
         "Comma-separated list of eval configs to run.")
  string("ensemble_dim", "number", "Name of the ensemble dimension.")
  string("rename_variables", None,
         'Dict literal of renames, e.g. {"2t": "2m_temperature"}')
  boolean("skipna", False, "Skip NaNs when evaluating.")
  boolean("pressure_level_suffixes", False,
          "Decode pressure-level-suffixed variable names.")
  listing("levels", ["500", "700", "850"], "Pressure levels to evaluate.")
  listing("variables", list(_DEFAULT_VARIABLES), "Variables to evaluate.")
  listing("aux_variables", None, "Auxiliary forecast variables.")
  listing("derived_variables", [],
          "Derived variables to compute on the fly.")
  string("threshold_method", "quantile",
         '"quantile" or "gaussian_quantile".')
  listing("quantile_thresholds", [],
          "Climatological quantiles for the binary metrics.")
  string("time_start", "2020-01-01", "Inclusive evaluation start time.")
  string("time_stop", "2020-12-31", "Inclusive evaluation stop time.")
  string("output_dir", None, "Directory for results files.")
  string("output_file_prefix", "", "Prefix for results filenames.")
  f.chunks("input_chunks", "init_time=32",
           "Chunk sizes for streaming the forecast through the engine, "
           "e.g. init_time=32,lead_time=7.")
  boolean("use_mesh", False,
          "Run via the streaming engine instead of fully in memory.")
  boolean("use_beam", False, "Compatibility alias for --use_mesh.")
  integer("n_devices", None, "Number of devices (not ported yet).")
  # accepted for CLI compatibility with the reference; ignored
  string("runner", None, "(ignored)")
  integer("fanout", None, "(ignored)")
  integer("num_threads", None, "(ignored)")
  boolean("shuffle_before_temporal_mean", False, "(ignored)")
  string("checkpoint_path", None,
         "Base path for streaming accumulator checkpoints (one file per "
         "group of eval configs); existing files resume the run. Only "
         "with --use_mesh.")
  integer("checkpoint_every", 0,
          "Checkpoint the streaming accumulators every N chunks (0=off).")
  f.device()
  return f.parser


def _wind_vector_error(err_type: str, args) -> list:
  """WindVector[R]MSE metrics for each available U/V pair."""
  cls = {"mse": metrics.WindVectorMSE,
         "rmse": metrics.WindVectorRMSESqrtBeforeTimeAvg}[err_type]
  available = set(args.variables).union(args.derived_variables)
  return [cls(u_name=u, v_name=v, vector_name=name)
          for u, v, name in _WIND_PAIRS
          if u in available and v in available]


def predefined_regions_dict(land_sea_mask=None) -> dict:
  """The 13 predefined box regions (+3 land regions when a mask exists)."""
  et_lats = [slice(None, -20), slice(20, None)]
  regions = {
      "global": SliceRegion(),
      "tropics": SliceRegion(lat_slice=slice(-20, 20)),
      "extra-tropics": SliceRegion(lat_slice=et_lats),
      "northern-hemisphere": SliceRegion(lat_slice=slice(20, None)),
      "southern-hemisphere": SliceRegion(lat_slice=slice(None, -20)),
      "europe": SliceRegion(
          lat_slice=slice(35, 75),
          lon_slice=[slice(360 - 12.5, None), slice(0, 42.5)]),
      "north-america": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(360 - 120, 360 - 75)),
      "north-atlantic": SliceRegion(
          lat_slice=slice(25, 65), lon_slice=slice(360 - 70, 360 - 10)),
      "north-pacific": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(145, 360 - 130)),
      "east-asia": SliceRegion(
          lat_slice=slice(25, 60), lon_slice=slice(102.5, 150)),
      "ausnz": SliceRegion(
          lat_slice=slice(-45, -12.5), lon_slice=slice(120, 175)),
      "arctic": SliceRegion(lat_slice=slice(60, 90)),
      "antarctic": SliceRegion(lat_slice=slice(-90, -60)),
  }
  if land_sea_mask is not None:
    lr = LandRegion(land_sea_mask=land_sea_mask)
    regions["global_land"] = lr
    regions["extra-tropics_land"] = CombinedRegion(
        regions=[SliceRegion(lat_slice=et_lats), lr])
    regions["tropics_land"] = CombinedRegion(
        regions=[SliceRegion(lat_slice=slice(-20, 20)), lr])
  return regions


def probe_land_sea_mask(args):
  """The ``land_sea_mask`` of ``--lsm_dataset`` (else of the obs store),
  or None.  The store opens lazily and only the mask is read."""
  lsm_path = args.lsm_dataset or args.obs_path
  try:
    lsm_ds = xds.open_zarr(lsm_path, lazy=True)
    if "land_sea_mask" in lsm_ds:
      mask_da = lsm_ds["land_sea_mask"]
      return mask_da.copy(data=np.asarray(mask_da.data))
  except Exception as e:  # pylint: disable=broad-except
    if args.lsm_dataset:
      # an explicitly requested mask store must not be silently skipped
      raise
    print(f"Could not probe {lsm_path!r} for land_sea_mask: {e}")
  print("No land_sea_mask found.")
  return None


def build_eval_configs(args, climatology, regions, threshold_list) -> dict:
  """The twelve predefined eval configs, keyed by name."""
  ens = dict(ensemble_dim=args.ensemble_dim)
  derived = {name: DERIVED_VARIABLE_DICT[name]
             for name in args.derived_variables}
  prob_clim = dict(
      evaluate_probabilistic_climatology=(
          args.evaluate_probabilistic_climatology),
      probabilistic_climatology_start_year=(
          args.probabilistic_climatology_start_year),
      probabilistic_climatology_end_year=(
          args.probabilistic_climatology_end_year),
      probabilistic_climatology_hour_interval=(
          args.probabilistic_climatology_hour_interval))
  baselines = dict(evaluate_persistence=args.evaluate_persistence,
                   evaluate_climatology=args.evaluate_climatology,
                   derived_variables=derived)
  deterministic_metrics = {
      "mse": metrics.MSE(wind_vector_mse=_wind_vector_error("mse", args)),
      "acc": metrics.ACC(climatology=climatology),
      "bias": metrics.Bias(),
      "mae": metrics.MAE(),
  }
  spatial_metrics = {
      "bias": metrics.SpatialBias(),
      "mse": metrics.SpatialMSE(),
      "mae": metrics.SpatialMAE(),
  }
  if args.compute_seeps:
    if climatology is None:
      raise ValueError(
          "--compute_seeps requires --climatology_path (SEEPS needs "
          "climatological dry fractions and thresholds)")
    for name, precip, thresh in [
        ("seeps_24hr", "total_precipitation_24hr", 0.25),
        ("seeps_6hr", "total_precipitation_6hr", 0.1),
    ]:
      if f"{precip}_seeps_threshold" not in climatology:
        continue  # climatology lacks SEEPS stats for this accumulation
      seeps_kwargs = dict(climatology=climatology, precip_name=precip,
                          dry_threshold_mm=thresh)
      deterministic_metrics[name] = metrics.SEEPS(**seeps_kwargs)
      spatial_metrics[name] = metrics.SpatialSEEPS(**seeps_kwargs)
  return {
      "deterministic": config.Eval(
          metrics=deterministic_metrics, regions=regions, **baselines),
      "deterministic_spatial": config.Eval(
          metrics=spatial_metrics, output_format="zarr", **baselines),
      "deterministic_temporal": config.Eval(
          metrics={
              **deterministic_metrics,
              "rmse_sqrt_before_time_avg": metrics.RMSESqrtBeforeTimeAvg(
                  wind_vector_rmse=_wind_vector_error("rmse", args)),
          },
          regions=regions, temporal_mean=False, **baselines),
      "deterministic_vs_analysis": config.Eval(
          metrics=deterministic_metrics, against_analysis=True,
          regions=regions, derived_variables=derived),
      "probabilistic": config.Eval(
          metrics={
              "crps": metrics.CRPS(**ens),
              "crps_spread": metrics.CRPSSpread(**ens),
              "crps_skill": metrics.CRPSSkill(**ens),
              "ensemble_mean_mse": metrics.EnsembleMeanMSE(**ens),
              "debiased_ensemble_mean_mse": metrics.DebiasedEnsembleMeanMSE(
                  **ens),
              "ensemble_variance": metrics.EnsembleVariance(**ens),
          },
          regions=regions, derived_variables=derived, **prob_clim),
      "ensemble_binary": config.Eval(
          metrics={
              "brier_score": metrics.EnsembleBrierScore(
                  thresholds=threshold_list, **ens),
              "debiased_brier_score": metrics.DebiasedEnsembleBrierScore(
                  thresholds=threshold_list, **ens),
              "ignorance_score": metrics.EnsembleIgnoranceScore(
                  thresholds=threshold_list, **ens),
          },
          regions=regions, derived_variables=derived, **prob_clim),
      "ensemble_forecast_vs_era_experimental_metrics": config.Eval(
          metrics={
              "energy_score": metrics.EnergyScore(**ens),
              "energy_score_spread": metrics.EnergyScoreSpread(**ens),
              "energy_score_skill": metrics.EnergyScoreSkill(**ens),
              "ensemble_mean_rmse_sqrt_before_time_avg": (
                  metrics.EnsembleMeanRMSESqrtBeforeTimeAvg(**ens)),
              "ensemble_stddev_sqrt_before_time_avg": (
                  metrics.EnsembleStddevSqrtBeforeTimeAvg(**ens)),
          },
          derived_variables=derived),
      "probabilistic_spatial": config.Eval(
          metrics={
              "crps": metrics.SpatialCRPS(**ens),
              "crps_spread": metrics.SpatialCRPSSpread(**ens),
              "crps_skill": metrics.SpatialCRPSSkill(**ens),
              "ensemble_mean_mse": metrics.SpatialEnsembleMeanMSE(**ens),
              "debiased_ensemble_mean_mse": (
                  metrics.DebiasedSpatialEnsembleMeanMSE(**ens)),
              "ensemble_variance": metrics.SpatialEnsembleVariance(**ens),
          },
          derived_variables=derived, output_format="zarr", **prob_clim),
      "ensemble_binary_spatial": config.Eval(
          metrics={
              "brier_score": metrics.SpatialEnsembleBrierScore(
                  thresholds=threshold_list, **ens),
              "debiased_brier_score": (
                  metrics.SpatialDebiasedEnsembleBrierScore(
                      thresholds=threshold_list, **ens)),
              "ignorance_score": metrics.SpatialEnsembleIgnoranceScore(
                  thresholds=threshold_list, **ens),
          },
          derived_variables=derived, output_format="zarr", **prob_clim),
      "probabilistic_spatial_histograms": config.Eval(
          metrics={"rank_histogram": metrics.RankHistogram(**ens)},
          derived_variables=derived, output_format="zarr", **prob_clim),
      "gaussian_probabilistic": config.Eval(
          metrics={
              "crps": metrics.GaussianCRPS(),
              "ensemble_variance": metrics.GaussianVariance(),
          },
          regions=regions, derived_variables=derived),
      "gaussian_binary": config.Eval(
          metrics={
              "brier_score": metrics.GaussianBrierScore(
                  thresholds=threshold_list),
              "ignorance_score": metrics.GaussianIgnoranceScore(
                  thresholds=threshold_list),
          },
          regions=regions, derived_variables=derived),
  }


def _refuse_unported(args) -> None:
  if args.n_devices:
    raise NotImplementedError("--n_devices is not ported yet (ROADMAP A.12)")


def main(argv=None):
  """Parse ``argv`` (default: the command line) and run the evaluation;
  returns the streaming engine's counts, or None for an in-memory run."""
  args = build_parser().parse_args(argv)
  _refuse_unported(args)
  requested = args.eval_configs.split(",")

  data_config = config.Data(
      selection=config.Selection(
          variables=args.variables,
          aux_variables=args.aux_variables,
          levels=[int(level) for level in args.levels],
          time_slice=slice(args.time_start, args.time_stop)),
      paths=config.Paths(
          forecast=args.forecast_path, obs=args.obs_path,
          climatology=args.climatology_path, output_dir=args.output_dir,
          output_file_prefix=args.output_file_prefix),
      by_init=args.by_init,
      rename_variables=(ast.literal_eval(args.rename_variables)
                        if args.rename_variables else None),
      pressure_level_suffixes=args.pressure_level_suffixes)

  predefined = predefined_regions_dict(probe_land_sea_mask(args))
  if args.regions == ["all"]:
    regions = predefined
  elif args.regions is None:
    regions = None
  else:
    regions = {k: v for k, v in predefined.items() if k in args.regions}

  climatology = None
  if args.climatology_path:
    # lazy: an hourly 0.25-degree climatology is hundreds of GB; ACC, SEEPS
    # and the climatology baseline gather bounded slices per chunk
    climatology = evaluation.make_latitude_increasing(
        xds.open_zarr(args.climatology_path, lazy=True))

  threshold_list = []
  if args.quantile_thresholds:
    threshold_cls = thresholds.get_threshold_cls(args.threshold_method)
    threshold_list = [threshold_cls(climatology=climatology, quantile=float(q))
                      for q in args.quantile_thresholds]

  eval_configs = build_eval_configs(args, climatology, regions,
                                    threshold_list)
  if not set(requested).issubset(eval_configs):
    raise ValueError(
        f"--eval_configs={args.eval_configs} is not a subset of "
        f"{sorted(eval_configs)}")
  eval_configs = {k: v for k, v in eval_configs.items() if k in requested}

  if climatology is None:
    # fail fast with a clear message instead of a NoneType error deep in
    # the first chunk
    for cfg_name, cfg in eval_configs.items():
      needy = [m_name for m_name, m in cfg.metrics.items()
               if getattr(m, "climatology", "absent") is None]
      if needy:
        raise ValueError(
            f"--eval_configs={cfg_name} includes metrics {needy} that "
            "require a climatology; pass --climatology_path")

  if args.use_mesh or args.use_beam:
    return evaluation.evaluate_with_mesh(
        data_config, eval_configs, input_chunks=args.input_chunks,
        skipna=args.skipna, device=args.device,
        checkpoint_path=args.checkpoint_path,
        checkpoint_every=args.checkpoint_every)
  evaluation.evaluate_in_memory(data_config, eval_configs,
                                skipna=args.skipna, device=args.device)
  return None


if __name__ == "__main__":
  main()
