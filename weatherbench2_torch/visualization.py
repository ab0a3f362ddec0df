"""Visualization of saved verification results.

Counterpart of ``weatherbench2_tpu/visualization.py`` (set_wb2_style,
load_results, compute_relative_metrics, compute_spread_skill_ratio,
plot_timeseries, visualize_timeseries, visualize_scorecard) on the port's
labeled arrays: results datasets with dims ``(metric, region,
lead_time[, level])``, read from the port's NetCDF3 or Zarr results.  The
computing functions need numpy only; the plotting ones import matplotlib
when they are called, and without it raise an ``ImportError`` that names
it.
"""
import typing as t

import numpy as np

from weatherbench2_torch import config
from weatherbench2_torch import xds

long2short = {
    "geopotential": "Z",
    "temperature": "T",
    "specific_humidity": "Q",
    "u_component_of_wind": "U",
    "v_component_of_wind": "V",
    "10m_u_component_of_wind": "U10",
    "10m_v_component_of_wind": "V10",
    "mean_sea_level_pressure": "MSLP",
    "2m_temperature": "T2M",
    "total_precipitation_6hr": "TP6h",
    "total_precipitation_24hr": "TP24h",
    "wind_speed": "WS",
    "10m_wind_speed": "WS10",
    "wind_vector": "WV",
    "10m_wind_vector": "WV10",
}

units = {
    "geopotential": "m$^2$/s$^{2}$",
    "temperature": "K",
    "specific_humidity": "g/kg",
    "u_component_of_wind": "m/s",
    "v_component_of_wind": "m/s",
    "10m_u_component_of_wind": "m/s",
    "10m_v_component_of_wind": "m/s",
    "2m_temperature": "K",
    "mean_sea_level_pressure": "Pa",
    "total_precipitation_6hr": "mm",
    "total_precipitation_24hr": "mm",
    "wind_speed": "m/s",
    "10m_wind_speed": "m/s",
    "wind_vector": "m/s",
    "10m_wind_vector": "m/s",
}

_PERFECT_SCORES = {"acc": 1.0, "rmse": 0.0, "mse": 0.0, "bias": 0.0}


def _pyplot():
  """``matplotlib.pyplot``, imported when a plot is made."""
  try:
    import matplotlib.pyplot as plt
  except ImportError as err:
    raise ImportError(
        "the plotting functions of weatherbench2_torch.visualization need "
        "matplotlib, which is not installed; load_results, "
        "compute_relative_metrics and compute_spread_skill_ratio do not"
    ) from err
  return plt


def set_wb2_style() -> None:
  """Set matplotlib defaults to the WB2 plot style."""
  plt = _pyplot()
  plt.rcParams["axes.grid"] = True
  plt.rcParams["lines.linewidth"] = 2
  plt.rcParams["figure.facecolor"] = "None"
  plt.rcParams["axes.facecolor"] = "0.95"
  plt.rcParams["grid.color"] = "white"
  plt.rcParams["axes.spines.right"] = False
  plt.rcParams["axes.spines.top"] = False


def _insert_perfect_t0(r: xds.Dataset) -> xds.Dataset:
  """Prepend perfect scores at lead_time=0 when missing."""
  lead = np.asarray(r.coords_dict()["lead_time"].data)
  if lead[0] <= np.timedelta64(0, "ns"):
    return r
  metric_names = np.asarray(r.coords_dict()["metric"].data)
  lt0 = r.isel(lead_time=[0])
  new_data = {}
  for name, var in lt0.variables_dict().items():
    vals = np.asarray(xds._xp.to_numpy(var.data), dtype=np.float64).copy()
    m_ax = var.dims.index("metric")
    for i, m in enumerate(metric_names.tolist()):
      if m in _PERFECT_SCORES:
        key = [slice(None)] * vals.ndim
        key[m_ax] = i
        vals[tuple(key)] = _PERFECT_SCORES[m]
    new_data[name] = vals
  lt0 = lt0.copy(data=new_data)
  lt0 = lt0.assign_coords(
      lead_time=np.array([np.timedelta64(0, "h")], dtype="timedelta64[ns]")
  )
  return xds.concat([lt0, r], "lead_time")


def load_results(results_dict: t.Dict[str, t.Any]) -> t.Dict[str, xds.Dataset]:
  """Load result files (NetCDF3 or Zarr), inserting perfect t=0 scores; a
  NetCDF4 file is refused with an error that names the format."""
  results = {}
  for name, path_or_ds in results_dict.items():
    if isinstance(path_or_ds, xds.Dataset):
      results[name] = path_or_ds
      continue
    if str(path_or_ds).endswith(".zarr"):
      r = xds.open_zarr(path_or_ds)
    else:
      r = xds.open_netcdf(path_or_ds)
    results[name] = _insert_perfect_t0(r)
  return results


def datetime_to_xticks(lead_time, ax, xlim=None) -> None:
  """Set whole-day x ticks for a lead_time axis plotted in float days
  (the unit `plot_timeseries` uses for its x data)."""
  values = np.asarray(
      lead_time.data if hasattr(lead_time, "data") else lead_time
  )
  days = values.astype("timedelta64[h]").astype(np.float64) / 24.0
  lo, hi = float(days.min()), float(days.max())
  if xlim is not None:
    lo, hi = float(np.min(xlim)), float(np.max(xlim))
  ticks = np.arange(np.ceil(lo), np.floor(hi) + 1)
  ax.set_xticks(ticks)
  ax.set_xticklabels(ticks.astype(np.int64))
  ax.set_xlim(lo, hi)


def compute_relative_metrics(
    results: t.Dict[str, xds.Dataset], reference: str, metric: str
) -> t.Dict[str, xds.Dataset]:
  """Percent improvement of each result vs a reference result."""

  def relative_percent(fc: xds.Dataset, baseline: xds.Dataset):
    lead = np.asarray(fc.coords_dict()["lead_time"].data)
    mask = lead > np.timedelta64(0, "ns")

    def apply(da: xds.DataArray, base_da: xds.DataArray):
      if metric == "acc":
        rel = (da - base_da) / (1 - base_da) * 100
      else:
        rel = (da - base_da) / base_da * 100
      vals = np.asarray(rel.values, dtype=np.float64).copy()
      ax = rel.dims.index("lead_time")
      key = [slice(None)] * vals.ndim
      key[ax] = ~mask
      vals[tuple(key)] = np.nan
      return rel.copy(data=vals)

    out = xds.Dataset({}, coords=dict(fc.coords_dict()))
    for k in fc.keys():
      if k in baseline:
        out[k] = apply(fc[k], baseline[k])
    return out

  baseline = results[reference]
  return {
      k: relative_percent(v, baseline)
      for k, v in results.items()
      if k != reference
  }


def compute_spread_skill_ratio(da: xds.DataArray) -> xds.DataArray:
  """Spread/skill ratio from stddev and ensemble-mean RMSE metrics."""
  spread = da.sel(metric="ensemble_stddev")
  skill = da.sel(metric="ensemble_mean_rmse")
  ratio = spread / skill
  lead = np.asarray(ratio.coords["lead_time"].data)
  vals = np.asarray(ratio.values, dtype=np.float64).copy()
  ax = ratio.dims.index("lead_time")
  key = [slice(None)] * vals.ndim
  key[ax] = lead <= np.timedelta64(0, "ns")
  vals[tuple(key)] = np.nan
  return ratio.copy(data=vals)


def _select_panel_da(
    ds: xds.Dataset, panel: config.Panel
) -> xds.DataArray:
  da = ds[panel.variable].sel(metric=panel.metric)
  if panel.region is not None and "region" in da.dims:
    da = da.sel(region=panel.region)
  if panel.level is not None and "level" in da.dims:
    da = da.sel(level=panel.level)
  return da


def plot_timeseries(
    results: t.Dict[str, xds.Dataset],
    metric: str,
    variable: str,
    level: t.Optional[int] = None,
    region: t.Optional[str] = None,
    colors: t.Optional[t.Dict[str, str]] = None,
    labels: t.Optional[t.Dict[str, str]] = None,
    linestyles: t.Optional[t.Dict[str, str]] = None,
    relative: t.Optional[str] = None,
    title: t.Optional[str] = None,
    xlabel: t.Optional[str] = None,
    ylabel: t.Optional[str] = None,
    ylim: t.Optional[tuple] = None,
    xlim: t.Optional[tuple] = None,
    ax=None,
    marker: t.Optional[str] = None,
    markersize: t.Optional[int] = None,
):
  """Plot one metric/variable timeseries panel across result sets."""
  plt = _pyplot()
  if ax is None:
    _, ax = plt.subplots(figsize=(6, 4))

  if relative is not None:
    plot_results = compute_relative_metrics(results, relative, metric)
  else:
    plot_results = results

  # reference semantics (reference visualization.py:175-204): synthesized
  # metrics, x1000 unit conversion for humidity/precip, and baseline
  # exclusion for relative/ACC/spread-skill panels
  _SCALE_METRICS = ("crps", "rmse", "spread&skill", "rms_bias")
  _SCALE_VARS = (
      "specific_humidity", "total_precipitation_6hr",
      "total_precipitation_24hr",
  )
  for name, ds in plot_results.items():
    if (relative is not None or metric in ("acc", "spread/skill")) and (
        "climatology_" in name or "persistence_" in name
    ):
      continue
    if variable not in ds.keys():
      continue
    spread_da = None
    try:
      if metric == "spread&skill":
        da = ds[variable].sel(metric="ensemble_mean_rmse")
        spread_da = ds[variable].sel(metric="ensemble_stddev")
      elif metric == "spread/skill":
        da = compute_spread_skill_ratio(ds[variable])
        ax.axhline(1, color="k")
      elif metric == "1-seeps":
        da = 1 - ds[variable].sel(metric="seeps")
      else:
        da = ds[variable].sel(metric=metric)
    except KeyError:
      continue

    def _narrow(d):
      if region is not None and "region" in d.dims:
        d = d.sel(region=region)
      if level is not None and "level" in d.dims:
        d = d.sel(level=level)
      if (
          relative is None
          and metric in _SCALE_METRICS
          and variable in _SCALE_VARS
      ):
        d = d * 1000.0
      return d

    da = _narrow(da)
    if spread_da is not None:
      spread_da = _narrow(spread_da)
    lead_days = np.asarray(
        da.coords["lead_time"].data, dtype="timedelta64[h]"
    ).astype(np.float64) / 24.0
    kwargs = {}
    if colors and name in colors:
      kwargs["color"] = colors[name]
    if linestyles and name in linestyles:
      kwargs["linestyle"] = linestyles[name]
    if marker:
      kwargs["marker"] = marker
      kwargs["markersize"] = markersize
    label = labels.get(name, name) if labels else name
    ax.plot(lead_days, np.asarray(da.values, dtype=np.float64),
            label=label, **kwargs)
    if spread_da is not None:
      ax.plot(
          lead_days, np.asarray(spread_da.values, dtype=np.float64),
          linestyle="--", color=ax.lines[-1].get_color(),
      )

  short = long2short.get(variable, variable)
  unit = units.get(variable, "")
  ax.set_title(title or f"{metric.upper()} {short}"
               + (f" {level}" if level else ""))
  ax.set_xlabel(xlabel or "Lead time [days]")
  ax.set_ylabel(
      ylabel
      or (f"{metric.upper()} [{unit}]" if relative is None else "% change")
  )
  if ylim is not None:
    ax.set_ylim(ylim)
  if xlim is not None:
    ax.set_xlim(xlim)
  ax.legend(fontsize=8)
  return ax


def visualize_timeseries(
    viz_config: config.Viz, panel_configs: t.Sequence[config.Panel]
) -> None:
  """Grid of timeseries panels, saved per viz_config.save_kwargs."""
  plt = _pyplot()
  set_wb2_style()
  results = load_results(viz_config.results)
  n = len(panel_configs)
  if viz_config.layout is not None:
    rows, cols = viz_config.layout
  else:
    cols = min(n, 3)
    rows = -(-n // cols)
  figsize = viz_config.figsize or (4 * cols, 3.5 * rows)
  fig, axes = plt.subplots(rows, cols, figsize=figsize, squeeze=False)
  for i, panel in enumerate(panel_configs):
    ax = axes[i // cols][i % cols]
    plot_timeseries(
        results,
        metric=panel.metric,
        variable=panel.variable,
        level=panel.level,
        region=panel.region,
        relative=panel.relative,
        colors=viz_config.colors,
        labels=viz_config.labels,
        linestyles=viz_config.linestyles,
        title=panel.title,
        xlabel=panel.xlabel,
        ylabel=panel.ylabel,
        ylim=panel.ylim,
        xlim=panel.xlim,
        marker=viz_config.marker,
        markersize=viz_config.markersize,
        ax=ax,
    )
  if viz_config.tight_layout:
    fig.tight_layout()
  if viz_config.save_kwargs:
    fig.savefig(**viz_config.save_kwargs)
  return fig


def visualize_scorecard(
    viz_config: config.Viz,
    baseline: str,
    forecast: str,
    metric: str,
    variables: t.Sequence[str],
    levels: t.Optional[t.Sequence[int]] = None,
    region: t.Optional[str] = None,
    cmap: str = "RdBu_r",
    vlim: float = 50.0,
):
  """Heatmap scorecard of % improvement of `forecast` over `baseline`.

  Rows are (variable[, level]); columns are lead times.
  """
  plt = _pyplot()
  set_wb2_style()
  results = load_results(viz_config.results)
  relative = compute_relative_metrics(results, baseline, metric)[forecast]

  rows = []
  row_labels = []
  for variable in variables:
    if variable not in relative:
      continue
    da = relative[variable].sel(metric=metric)
    if region is not None and "region" in da.dims:
      da = da.sel(region=region)
    if "level" in da.dims:
      for level in levels or np.asarray(
          da.coords["level"].data
      ).tolist():
        rows.append(
            np.asarray(da.sel(level=level).values, dtype=np.float64)
        )
        row_labels.append(f"{long2short.get(variable, variable)}{level}")
    else:
      rows.append(np.asarray(da.values, dtype=np.float64))
      row_labels.append(long2short.get(variable, variable))

  matrix = np.stack(rows)
  lead_days = (
      np.asarray(
          relative.coords_dict()["lead_time"].data, dtype="timedelta64[h]"
      ).astype(np.float64)
      / 24.0
  )
  fig, ax = plt.subplots(
      figsize=viz_config.figsize or (10, 0.5 * len(rows) + 2)
  )
  im = ax.imshow(
      matrix, cmap=cmap, vmin=-vlim, vmax=vlim, aspect="auto",
      interpolation="nearest",
  )
  ax.set_yticks(np.arange(len(row_labels)))
  ax.set_yticklabels(row_labels)
  step = max(1, len(lead_days) // 10)
  ax.set_xticks(np.arange(len(lead_days))[::step])
  ax.set_xticklabels([f"{d:.0f}" for d in lead_days[::step]])
  ax.set_xlabel("Lead time [days]")
  ax.set_title(f"{forecast} vs {baseline}: {metric.upper()} [% change]")
  fig.colorbar(im, ax=ax, shrink=0.8)
  if viz_config.tight_layout:
    fig.tight_layout()
  if viz_config.save_kwargs:
    fig.savefig(**viz_config.save_kwargs)
  return fig
