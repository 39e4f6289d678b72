"""TimeSeriesModel (ExponentialSmoothing, ARIMA) → PyTorch forecasts.

The port of ``flink_jpmml_tpu/compile/timeseries.py``. The temporal state
is in the document; each record carries the forecast horizon h (first
active MiningField, integer ≥ 1, rounded), so scoring stays a pure
batched function:

- ExponentialSmoothing — closed form, branch-free:

      ŷ(h) = level (+ h·trend | + trend·φ(1−φ^h)/(1−φ)   additive forms)
             (· trend^h | · trend^(φ(1−φ^h)/(1−φ))  multiplicative forms)
                   (+ seasonal[(h−1) mod period]  |  × seasonal[…])

  φ^h and trend^x lower as exp(x·ln b), with the ``level == 0`` guard
  against 0·inf on overflow; the seasonal index is ``torch.remainder``
  (``jnp.mod``'s sign convention; ``torch.fmod`` would differ for
  negative operands) of the horizon saturated at 2³¹ − 1, as the JAX
  package's int32 cast saturates (its oracle does not: past that horizon
  the compiled paths and the oracle pick another season).

- ARIMA — the whole forecast path ŷ(1..H_MAX) is precomputed once on the
  host in float64 (:func:`arima_forecast_path`, the JAX package's numpy
  code, copied with ``_combine_poly``) and the hot path is one gather by
  horizon, clamped to [1, H_MAX].

A missing horizon scores as an empty lane either way.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from flink_jpmml_tpu_torch.compile.common import Lowered, LowerCtx, ModelOutput
from flink_jpmml_tpu_torch.pmml import ir

# compiled-path forecast table length: horizons beyond clamp to the last
# entry (documented in docs/pmml_support.md; the oracle clamps the same)
ARIMA_H_MAX = ir.ARIMA_H_MAX


def _combine_poly(
    coef: Tuple[float, ...], scoef: Tuple[float, ...], s: int
) -> List[Tuple[int, float]]:
    """(1 − Σc_i B^i)(1 − ΣC_I B^{sI}) → the lag/coefficient pairs of the
    combined subtracted polynomial: 1 − Σ out[lag]·B^lag."""
    out: Dict[int, float] = {}
    for i, c in enumerate(coef, 1):
        out[i] = out.get(i, 0.0) + c
    for bigi, bigc in enumerate(scoef, 1):
        out[s * bigi] = out.get(s * bigi, 0.0) + bigc
        for i, c in enumerate(coef, 1):
            out[i + s * bigi] = out.get(i + s * bigi, 0.0) - c * bigc
    return sorted(out.items())


def arima_forecast_path(a: ir.ArimaIR, h_max: int = ARIMA_H_MAX) -> np.ndarray:
    """ŷ(1..h_max) under the CLS recursion, float64 on the host.

    Differencing order here: seasonal (1−B^s)^D first, then regular
    (1−B)^d; inversion mirrors it. (The operators commute — the oracle
    interpreter deliberately composes them the other way round, so the
    golden/fuzz parity suites cross-check both orderings.)"""
    s = a.period
    z = np.asarray(a.history, np.float64)
    if a.transformation == "logarithmic":
        z = np.log(z)
    elif a.transformation == "squareroot":
        z = np.sqrt(z)

    # seasonal differencing ladder (z → u), then regular (u → w)
    slevels = [z]
    for _ in range(a.sd):
        slevels.append(slevels[-1][s:] - slevels[-1][:-s])
    levels = [slevels[-1]]
    for _ in range(a.d):
        levels.append(levels[-1][1:] - levels[-1][:-1])
    w = levels[-1]

    ar_c = _combine_poly(a.ar, a.sar, s)
    ma_c = _combine_poly(a.ma, a.sma, s)
    res = np.asarray(a.residuals, np.float64)
    T = len(w)

    # W_{T+k} = c + Σ ar_c[lag]·W_{T+k−lag} + a_{T+k} − Σ ma_c[lag]·a_{T+k−lag}
    # with future a ≡ 0 and past a from the document's residuals
    wext = list(w)
    for k in range(1, h_max + 1):
        acc = a.constant
        for lag, c in ar_c:
            acc += c * wext[T + k - 1 - lag]
        for lag, c in ma_c:
            j = k - lag
            if j <= 0:  # a_{T+j}: observed residual (res[-1] is a_T)
                acc -= c * res[len(res) - 1 + j]
        wext.append(acc)
    fcur = np.asarray(wext[T:], np.float64)  # ŵ(1..h_max)

    # invert regular differencing (anchor: each ladder level's last value)
    for i in range(a.d, 0, -1):
        run = levels[i - 1][-1]
        out = np.empty_like(fcur)
        for k in range(fcur.shape[0]):
            run = run + fcur[k]
            out[k] = run
        fcur = out
    # invert seasonal differencing (anchor: each level's last s·1 values)
    for i in range(a.sd, 0, -1):
        ext = list(slevels[i - 1])
        out = np.empty_like(fcur)
        for k in range(fcur.shape[0]):
            v = fcur[k] + ext[len(ext) - s]
            out[k] = v
            ext.append(v)
        fcur = out

    # exploding forecasts (an AR polynomial outside the unit circle at
    # deep horizons) overflow to inf rather than warn: the table must be
    # total — the oracle returns inf for the same lanes
    with np.errstate(over="ignore"):
        if a.transformation == "logarithmic":
            fcur = np.exp(fcur)
        elif a.transformation == "squareroot":
            fcur = fcur * fcur
        return fcur.astype(np.float32)


def lower_time_series(model: ir.TimeSeriesIR, ctx: LowerCtx) -> Lowered:
    col = ctx.column(model.horizon_field)
    if model.arima is not None:
        path = arima_forecast_path(model.arima)
        h_max = float(path.shape[0])

        def fn_a(p, X, M):
            h = torch.clamp(torch.round(X[:, col]), 1.0, h_max)
            return ModelOutput(
                value=p["path"][h.to(torch.int64) - 1], valid=~M[:, col]
            )

        return Lowered(fn=fn_a, params={"path": path})
    s = model.smoothing
    params = {
        "level": np.float32(s.level),
        "trend": np.float32(s.trend),
    }
    if s.seasonal_type != "none":
        params["seasonal"] = np.asarray(s.seasonal, np.float32)
    trend_type = s.trend_type
    seasonal_type = s.seasonal_type
    period = s.period
    damped = trend_type.startswith("damped")
    log_phi = math.log(s.phi) if damped else 0.0
    phi_scale = s.phi / (1.0 - s.phi) if damped else 0.0
    # multiplicative trends lower as exp(x·ln b) (b > 0, checked at parse)
    log_trend = (
        math.log(s.trend) if trend_type.endswith("multiplicative") else 0.0
    )

    def fn(p, X, M):
        h = torch.clamp(torch.round(X[:, col]), min=1.0)
        y = p["level"].expand(h.shape)
        if trend_type == "additive":
            y = y + h * p["trend"]
        elif trend_type == "damped_additive":
            phi_h = torch.exp(h * log_phi)
            y = y + p["trend"] * phi_scale * (1.0 - phi_h)
        elif trend_type == "multiplicative":
            # level == 0 stays 0 even when exp overflows to inf
            y = torch.where(y == 0.0, y, y * torch.exp(h * log_trend))
        elif trend_type == "damped_multiplicative":
            phi_h = torch.exp(h * log_phi)
            y = torch.where(
                y == 0.0,
                y,
                y * torch.exp(phi_scale * (1.0 - phi_h) * log_trend),
            )
        if seasonal_type != "none":
            # the JAX package's int32 cast saturates past 2**31 - 1
            hi = torch.clamp(h, max=2.0 ** 31).to(torch.int64)
            idx = torch.remainder(torch.clamp(hi, max=2 ** 31 - 1) - 1, period)
            factor = p["seasonal"][idx]
            y = y + factor if seasonal_type == "additive" else y * factor
        return ModelOutput(value=y, valid=~M[:, col])

    return Lowered(fn=fn, params=params)
