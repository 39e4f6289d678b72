"""Durable telemetry history: fixed-interval delta frames + replay.

The port's copy of ``flink_jpmml_tpu/obs/history.py`` (numpy-free
stdlib over the port's metrics structs), with the import lines renamed:
the frame format, the exact dyadic arithmetic, the segment rings, the
resolution cascade and ``FJT_HISTORY_*`` are the JAX module's, so the
two packages write the same canonical frame JSON for the same
snapshots. Nothing differs.

Every sensor plane so far is point-in-time: a ``/metrics`` scrape or an
``fjt-top`` render shows *now*, and when a worker dies only the flight
ring survives. This module is the time axis those planes are missing —
each worker (and the supervisor's fleet aggregate) periodically turns
consecutive ``struct_snapshot()`` pairs into a **frame**:

- counters as window DELTAS (with a counter-reset fallback: a restarted
  worker's smaller cumulative becomes ``delta = cumulative``, counted in
  the frame's ``resets``),
- gauges as ``{min, max, last}`` over the window — ``last`` is kept
  PER SOURCE (``{src: [t1, value]}``) so the fleet "current value" can
  still be combined by each gauge's declared merge mode at read time,
- histograms as bucket deltas (sum/n deltas, layout carried).

Frames persist to bounded JSONL segment **rings** under
``FJT_HISTORY_DIR`` (byte-budgeted like the journey store, one ring per
resolution, write+flush so a SIGKILL tears at most the unflushed tail),
and are **downsampled** through a resolution cascade (default
``1s -> 15s -> 5m``) whose coarsening is :func:`merge_frames` — the
SAME operation that aggregates frames from N workers. Merging is done
in exact arithmetic (every float is a dyadic rational; sums that are
not float-representable are stored as ``[numerator, denominator]``
pairs), so the merge is associative and commutative BITWISE:

    downsample(merge(workers)) == merge(downsample(worker) each)

is an exact string equality on canonical frame JSON, frames from N
workers aggregate exactly, and a dead worker's history reads back like
a live one (its segments are already on disk; the supervisor's
``_fleet`` source keeps aggregating its last heartbeat snapshot).

Read side: :func:`query` (range + step + name selector — the
``/history`` endpoint), :func:`frame_to_struct` (a frame window
re-shaped as a ``struct_snapshot`` so every existing panel renders it:
``fjt-replay``), and :func:`capacity` helpers recording
``offered_rec_s`` / ``capacity_rec_s`` / ``headroom_frac`` per frame —
the future autoscaler's input signal.

With ``FJT_HISTORY_DIR`` unset, :func:`history_for` is a dict miss +
one env lookup and nothing records (the journey-store contract,
a few µs); armed, an accumulated-overhead budget
(``FJT_HISTORY_BUDGET``) bounds the bookkeeping like the drift plane's.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref
from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Tuple

from flink_jpmml_tpu_torch.utils.metrics import (
    _gauge_merge_mode,
    govern_limit,
    _RANK_FAMILY_DEFAULT,
    _series_split,
)
from flink_jpmml_tpu_torch.obs.trace import iter_jsonl

_DIR_ENV = "FJT_HISTORY_DIR"
_MAX_MB_ENV = "FJT_HISTORY_MAX_MB"
_INTERVAL_ENV = "FJT_HISTORY_INTERVAL_S"
_RES_ENV = "FJT_HISTORY_RES"
_BUDGET_ENV = "FJT_HISTORY_BUDGET"
_RANK_ENV = "FJT_METRICS_RANK_FAMILY"

_SEG_PREFIX = "frames-"
_SEG_BYTES = 256 << 10

#: The supervisor's fleet-aggregate source. Its frames are a MERGED
#: view of the same traffic the per-worker sources record, so default
#: queries exclude it (summing it alongside workers double-counts);
#: ask for it explicitly (``sources=["_fleet"]``) to read the
#: supervisor's own timeline — it keeps counting a dead worker's last
#: heartbeat snapshot, which is what makes the aggregate seamless
#: across worker death.
FLEET_SRC = "_fleet"

_DEFAULT_RES = (1.0, 15.0, 300.0)


def _env_float(name: str, fallback: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return fallback
    try:
        return float(raw)
    except ValueError:
        return fallback


def _resolutions_from_env() -> Tuple[float, ...]:
    raw = os.environ.get(_RES_ENV)
    if not raw:
        return _DEFAULT_RES
    out = []
    for part in raw.split(","):
        try:
            r = float(part)
        except ValueError:
            continue
        if r > 0:
            out.append(r)
    return tuple(sorted(set(out))) or _DEFAULT_RES


# ---------------------------------------------------------------------------
# Exact arithmetic codec. Floats are dyadic rationals, so converting to
# Fraction is EXACT; sums of Fractions are exact regardless of order —
# which is the whole bitwise-commutation story. A value goes back on
# the wire as a plain JSON number when the exact sum IS a float, else
# as a two-int [numerator, denominator] pair; floats only reappear at
# render time.
# ---------------------------------------------------------------------------


def _dec(v) -> Fraction:
    """Wire value → exact rational (plain number or [p, q] pair)."""
    if isinstance(v, (list, tuple)):
        return Fraction(int(v[0]), int(v[1]))
    return Fraction(float(v))


def _enc(x: Fraction):
    """Exact rational → wire value (plain number when exact)."""
    if x.denominator == 1:
        n = int(x)
        f = float(n)
        # ints beyond 2**53 are not float-exact: keep the pair form
        return n if int(f) == n and abs(n) <= (1 << 53) else [n, 1]
    try:
        f = float(x)
    except OverflowError:
        return [x.numerator, x.denominator]
    if Fraction(f) == x:
        return f
    return [x.numerator, x.denominator]


def wire_float(v) -> float:
    """Render-time float of a wire value (exactness ends here)."""
    return float(_dec(v))


def canonical(frame: dict) -> str:
    """Canonical JSON of a frame — the bitwise-comparison form."""
    return json.dumps(frame, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Frame capture: cumulative struct pair -> delta frame
# ---------------------------------------------------------------------------


def capture_frame(
    prev: dict,
    cur: dict,
    src: str,
    res: float,
    t0: Optional[float] = None,
    t1: Optional[float] = None,
) -> dict:
    """Delta frame between two cumulative ``struct_snapshot`` dicts of
    ONE source. A counter (or histogram) that went backwards means the
    worker restarted between captures — the fallback takes the new
    cumulative as the delta (everything since the restart, the best
    reconstruction available) and counts it in ``resets``; a backwards
    ``uptime_s`` flips every family into that fallback at once."""
    t0 = float(prev.get("ts") or 0.0) if t0 is None else float(t0)
    t1 = float(cur.get("ts") or 0.0) if t1 is None else float(t1)
    resets = 0
    restarted = False
    try:
        restarted = float(cur.get("uptime_s", 0.0)) < float(
            prev.get("uptime_s", 0.0)
        )
    except (TypeError, ValueError):
        pass

    counters: Dict[str, object] = {}
    pc = prev.get("counters") or {}
    for n, v in (cur.get("counters") or {}).items():
        try:
            c = Fraction(float(v))
            p = Fraction(float(pc.get(n, 0.0)))
        except (TypeError, ValueError):
            continue
        if restarted or c < p:
            counters[n] = _enc(c)
            resets += 1
        else:
            d = c - p
            if d:
                counters[n] = _enc(d)

    gauges: Dict[str, dict] = {}
    for n, g in (cur.get("gauges") or {}).items():
        try:
            v = float(g.get("value", 0.0))
        except (AttributeError, TypeError, ValueError):
            continue
        gauges[n] = {"min": v, "max": v, "last": {src: [t1, v]}}

    hists: Dict[str, dict] = {}
    ph = prev.get("histograms") or {}
    for n, st in (cur.get("histograms") or {}).items():
        try:
            d = _hist_delta(ph.get(n), st, restarted)
        except (AttributeError, KeyError, TypeError, ValueError):
            continue
        if d is None:
            continue
        state, was_reset = d
        if was_reset:
            resets += 1
        if state["n"] or state["counts"]:
            hists[n] = state

    return {
        "v": 1,
        "src": str(src),
        "res": float(res),
        "t0": t0,
        "t1": t1,
        "resets": resets,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
    }


def _hist_delta(prev_st, cur_st, restarted: bool):
    layout = list(cur_st["layout"])
    cur_counts = {int(k): int(v) for k, v in (cur_st.get("counts") or {}).items()}
    cur_sum = Fraction(float(cur_st.get("sum", 0.0)))
    cur_n = int(cur_st.get("n", 0))
    cur_max = float(cur_st.get("max", 0.0))
    reset = restarted or prev_st is None or list(
        prev_st.get("layout") or []
    ) != layout
    if not reset:
        prev_counts = {
            int(k): int(v) for k, v in (prev_st.get("counts") or {}).items()
        }
        d_counts = {}
        for i, c in cur_counts.items():
            d = c - prev_counts.get(i, 0)
            if d < 0:
                reset = True
                break
            if d:
                d_counts[i] = d
        if not reset:
            if any(i not in cur_counts for i in prev_counts):
                reset = True
        if not reset:
            d_n = cur_n - int(prev_st.get("n", 0))
            if d_n < 0:
                reset = True
    if reset:
        d_counts = dict(cur_counts)
        d_sum = cur_sum
        d_n = cur_n
        was_reset = prev_st is not None
    else:
        d_sum = cur_sum - Fraction(float(prev_st.get("sum", 0.0)))
        was_reset = False
    return (
        {
            "layout": layout,
            "counts": {str(i): c for i, c in sorted(d_counts.items())},
            "sum": _enc(d_sum),
            "n": int(d_n),
            "max": cur_max,
        },
        was_reset,
    )


# ---------------------------------------------------------------------------
# THE merge: fleet aggregation across sources == downsampling across
# time. Exact, associative, commutative — pinned bitwise in tests.
# ---------------------------------------------------------------------------


def merge_frames(frames: Iterable[dict], res: Optional[float] = None) -> dict:
    """Merge delta frames into one: counter deltas add exactly, gauge
    windows take min-of-min / max-of-max and union the per-source
    ``last`` maps (newest ``t1`` per source wins), histogram buckets
    add. One operation serves both axes of the worker x time grid,
    which is what makes ``downsample(merge) == merge(downsample)``
    exact. Frames that aren't dicts are skipped (heartbeat-garbage
    tolerance, same contract as ``merge_structs``)."""
    counters: Dict[str, Fraction] = {}
    gauges: Dict[str, dict] = {}
    hists: Dict[str, dict] = {}
    srcs = set()
    t0 = None
    t1 = None
    max_res = 0.0
    resets = 0
    for f in frames:
        if not isinstance(f, dict):
            continue
        # re-split compound labels so nested merges stay associative:
        # merge(merge(a,b), a) must label itself "a+b", not "a+a+b"
        srcs.update(str(f.get("src", "")).split("+"))
        try:
            ft0, ft1 = float(f.get("t0", 0.0)), float(f.get("t1", 0.0))
            t0 = ft0 if t0 is None else min(t0, ft0)
            t1 = ft1 if t1 is None else max(t1, ft1)
            max_res = max(max_res, float(f.get("res", 0.0)))
            resets += int(f.get("resets", 0))
        except (TypeError, ValueError):
            pass
        for n, v in (f.get("counters") or {}).items():
            try:
                counters[n] = counters.get(n, Fraction(0)) + _dec(v)
            except (TypeError, ValueError, ZeroDivisionError):
                continue
        for n, g in (f.get("gauges") or {}).items():
            try:
                lo, hi = float(g["min"]), float(g["max"])
                last = {
                    str(s): [float(tv[0]), float(tv[1])]
                    for s, tv in (g.get("last") or {}).items()
                }
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            agg = gauges.get(n)
            if agg is None:
                gauges[n] = {"min": lo, "max": hi, "last": last}
            else:
                agg["min"] = min(agg["min"], lo)
                agg["max"] = max(agg["max"], hi)
                for s, tv in last.items():
                    old = agg["last"].get(s)
                    # lexicographic (t1, value) max: deterministic on
                    # ties, associative either way
                    if old is None or (tv[0], tv[1]) > (old[0], old[1]):
                        agg["last"][s] = tv
        for n, st in (f.get("histograms") or {}).items():
            try:
                _merge_hist_into(hists, n, st)
            except (KeyError, IndexError, TypeError, ValueError):
                continue
    return {
        "v": 1,
        "src": srcs.pop() if len(srcs) == 1 else "+".join(sorted(srcs)),
        "res": float(res) if res is not None else max_res,
        "t0": t0 if t0 is not None else 0.0,
        "t1": t1 if t1 is not None else 0.0,
        "resets": resets,
        "counters": {n: _enc(v) for n, v in counters.items()},
        "gauges": {
            n: {
                "min": g["min"],
                "max": g["max"],
                "last": {
                    s: list(tv) for s, tv in sorted(g["last"].items())
                },
            }
            for n, g in gauges.items()
        },
        "histograms": hists,
    }


def _merge_hist_into(hists: Dict[str, dict], name: str, st: dict) -> None:
    layout = list(st["layout"])
    counts = {int(k): int(v) for k, v in (st.get("counts") or {}).items()}
    s = _dec(st.get("sum", 0.0))
    n = int(st.get("n", 0))
    mx = float(st.get("max", 0.0))
    agg = hists.get(name)
    if agg is not None and list(agg["layout"]) == layout:
        merged = {int(k): int(v) for k, v in agg["counts"].items()}
        for i, c in counts.items():
            merged[i] = merged.get(i, 0) + c
        hists[name] = {
            "layout": layout,
            "counts": {str(i): c for i, c in sorted(merged.items())},
            "sum": _enc(_dec(agg["sum"]) + s),
            "n": agg["n"] + n,
            "max": max(float(agg["max"]), mx),
        }
        return
    new = {
        "layout": layout,
        "counts": {str(i): c for i, c in sorted(counts.items())},
        "sum": _enc(s),
        "n": n,
        "max": mx,
    }
    if agg is None:
        hists[name] = new
        return
    # layout skew (a restart changed the histogram's range): keep the
    # deterministic max by (n, canonical layout) — a total order, so
    # the survivor is the same whatever the merge association. Exact
    # commutation is only claimed for stable layouts.
    old_key = (int(agg["n"]), json.dumps(agg["layout"]))
    new_key = (n, json.dumps(layout))
    if new_key > old_key:
        hists[name] = new


def downsample(frames: Iterable[dict], step: float) -> List[dict]:
    """Coarsen frames onto the ``step`` grid: group by
    ``floor(t0 / step)`` and :func:`merge_frames` each group. With
    nested grids (each resolution a multiple of the finer one — the
    default 1s/15s/5m cascade) cascaded downsampling lands every frame
    in the same slot as direct downsampling, so the results are
    bitwise identical."""
    step = float(step)
    slots: Dict[int, List[dict]] = {}
    for f in frames:
        if not isinstance(f, dict):
            continue
        try:
            slot = math.floor(float(f.get("t0", 0.0)) / step)
        except (TypeError, ValueError):
            continue
        slots.setdefault(slot, []).append(f)
    return [
        merge_frames(slots[slot], res=step) for slot in sorted(slots)
    ]


# ---------------------------------------------------------------------------
# Frame-level cardinality governor (the struct governor's exact-codec
# twin: frame counters/histogram sums may be [p, q] pairs, which
# govern_struct's float folds can't add exactly)
# ---------------------------------------------------------------------------


def govern_frame(frame: dict, max_series: Optional[int] = None) -> dict:
    k = govern_limit() if max_series is None else int(max_series)
    if k <= 0 or not isinstance(frame, dict):
        return frame
    rank_family = os.environ.get(_RANK_ENV, _RANK_FAMILY_DEFAULT)
    scores: Dict[Tuple[str, str], float] = {}
    for n, v in (frame.get("counters") or {}).items():
        parts = _series_split(n)
        if parts is not None and parts[0] == rank_family:
            try:
                scores[(parts[1], parts[2])] = float(_dec(v))
            except (TypeError, ValueError, ZeroDivisionError):
                pass

    def _weight(section: str, v) -> float:
        try:
            if section == "counters":
                return float(_dec(v))
            if section == "gauges":
                return float(v.get("max", 0.0))
            return float(v.get("n", 0))
        except (AttributeError, TypeError, ValueError,
                ZeroDivisionError):
            return 0.0

    out = None
    for section in ("counters", "gauges", "histograms"):
        sec = frame.get(section)
        if not isinstance(sec, dict):
            continue
        families: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for n in sec:
            parts = _series_split(n)
            if parts is not None:
                families.setdefault(
                    (parts[0], parts[1]), []
                ).append((parts[2], n))
        over = {
            fam: m for fam, m in families.items() if len(m) > k
        }
        if not over:
            continue
        governed = dict(sec)
        for (base, key), members in over.items():
            ranked = sorted(
                members,
                key=lambda lv: (
                    -scores.get((key, lv[0]), 0.0),
                    -_weight(section, sec[lv[1]]),
                    lv[0],
                ),
            )
            keep = {
                lv[1]
                for lv in [x for x in ranked if x[0] != "_other"][
                    : max(k - 1, 0)
                ]
            }
            folded = []
            for _, n in members:
                if n not in keep:
                    folded.append(governed.pop(n))
            other_name = f'{base}{{{key}="_other"}}'
            if section == "counters":
                total = Fraction(0)
                for v in folded:
                    try:
                        total += _dec(v)
                    except (TypeError, ValueError, ZeroDivisionError):
                        pass
                governed[other_name] = _enc(total)
            elif section == "gauges":
                sub = merge_frames(
                    [{"src": frame.get("src", ""),
                      "gauges": {other_name: g}} for g in folded]
                )
                got = sub["gauges"].get(other_name)
                if got is not None:
                    # fold "last" by the base family's merge mode: the
                    # per-source map would otherwise keep one entry per
                    # folded tenant via distinct values — collapse to a
                    # single pseudo-source
                    mode = _gauge_merge_mode(base)
                    vals = [tv[1] for tv in got["last"].values()]
                    ts = max(
                        (tv[0] for tv in got["last"].values()),
                        default=0.0,
                    )
                    if vals:
                        if mode == "max":
                            v = max(vals)
                        elif mode == "min":
                            v = min(vals)
                        else:
                            v = math.fsum(vals)
                        got["last"] = {
                            str(frame.get("src", "")): [ts, v]
                        }
                    governed[other_name] = got
            else:
                acc: Dict[str, dict] = {}
                for st in folded:
                    try:
                        _merge_hist_into(acc, other_name, st)
                    except (KeyError, IndexError, TypeError, ValueError):
                        continue
                if other_name in acc:
                    governed[other_name] = acc[other_name]
        if out is None:
            out = dict(frame)
        out[section] = governed
    return frame if out is None else out


# ---------------------------------------------------------------------------
# Frame -> struct (the replay bridge: every fjt-top panel renders it)
# ---------------------------------------------------------------------------


def combined_last(name: str, last: Dict[str, list]) -> float:
    """Collapse a per-source ``last`` map into the fleet's current
    value by the gauge's declared merge mode (sum / worst-of)."""
    vals = [float(tv[1]) for tv in (last or {}).values()]
    if not vals:
        return 0.0
    mode = _gauge_merge_mode(name)
    if mode == "max":
        return max(vals)
    if mode == "min":
        return min(vals)
    return math.fsum(vals)


def frame_to_struct(frame: dict) -> dict:
    """Re-shape a (possibly merged) frame as a ``struct_snapshot`` dict
    so :func:`obs.attr.summary`, the Prometheus renderer, and every
    ``fjt-top`` panel consume history exactly like a live scrape.
    Counters are the WINDOW deltas (so per-second rates computed
    against ``uptime_s`` = window span are window rates)."""
    t0 = float(frame.get("t0", 0.0))
    t1 = float(frame.get("t1", 0.0))
    gauges = {}
    for n, g in (frame.get("gauges") or {}).items():
        try:
            gauges[n] = {
                "value": combined_last(n, g.get("last")),
                "max": float(g.get("max", 0.0)),
            }
        except (AttributeError, TypeError, ValueError):
            continue
    counters = {}
    for n, v in (frame.get("counters") or {}).items():
        try:
            counters[n] = wire_float(v)
        except (TypeError, ValueError, ZeroDivisionError):
            continue
    hists = {}
    for n, st in (frame.get("histograms") or {}).items():
        try:
            hists[n] = {
                "layout": list(st["layout"]),
                "counts": dict(st.get("counts") or {}),
                "sum": wire_float(st.get("sum", 0.0)),
                "n": int(st.get("n", 0)),
                "max": float(st.get("max", 0.0)),
            }
        except (KeyError, TypeError, ValueError):
            continue
    return {
        "uptime_s": max(t1 - t0, 1e-9),
        "ts": t1,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
    }


# ---------------------------------------------------------------------------
# Durable rings: one JSONL segment ring per resolution
# ---------------------------------------------------------------------------


def _res_tag(res: float) -> str:
    return f"{res:g}".replace(".", "p") + "s"


class HistoryStore:
    """Byte-budgeted JSONL segment rings, one per resolution, sharing
    a directory (and its budget, split evenly) with other pids. Frames
    are write+flush — the OS page cache makes them SIGKILL-durable;
    a torn trailing line is skipped by the tolerant reader."""

    def __init__(
        self,
        directory: str,
        metrics=None,
        max_bytes: Optional[int] = None,
        resolutions: Tuple[float, ...] = _DEFAULT_RES,
        segment_bytes: int = _SEG_BYTES,
    ):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._metrics = metrics
        total = int(
            max_bytes if max_bytes is not None
            else _env_float(_MAX_MB_ENV, 32.0) * (1 << 20)
        )
        self._ring_budget = max(
            4096, total // max(len(resolutions), 1)
        )
        self._seg_bytes = max(4096, int(segment_bytes))
        self._rings: Dict[str, dict] = {}
        self._mu = threading.Lock()

    def _drop(self, reason: str, n: int = 1) -> None:
        if self._metrics is not None and n:
            self._metrics.counter(
                f'history_dropped{{reason="{reason}"}}'
            ).inc(n)

    def _ring(self, tag: str) -> dict:
        ring = self._rings.get(tag)
        if ring is None:
            prefix = f"{_SEG_PREFIX}{tag}-"
            pid_tag = f"{prefix}{os.getpid()}-"
            seq = 0
            for p in self._segments(prefix):
                nm = os.path.basename(p)
                if nm.startswith(pid_tag):
                    try:
                        seq = max(
                            seq, int(nm[len(pid_tag):-len(".jsonl")]) + 1
                        )
                    except ValueError:
                        pass
            ring = self._rings[tag] = {
                "prefix": prefix, "f": None, "f_bytes": 0, "seq": seq,
            }
        return ring

    def append(self, frame: dict) -> bool:
        """Durably append one frame to its resolution's ring."""
        tag = _res_tag(float(frame.get("res", 0.0)))
        line = canonical(frame) + "\n"
        with self._mu:
            ring = self._ring(tag)
            try:
                if ring["f"] is None:
                    ring["f"] = open(
                        os.path.join(
                            self.directory,
                            f"{ring['prefix']}{os.getpid()}-"
                            f"{ring['seq']:08d}.jsonl",
                        ),
                        "a", encoding="utf-8",
                    )
                    ring["f_bytes"] = 0
                ring["f"].write(line)
                ring["f"].flush()
            except (OSError, ValueError):
                ring["f"] = None  # disk gone: drop counted, stay alive
                self._drop("io_error")
                return False
            ring["f_bytes"] += len(line)
            if ring["f_bytes"] >= self._seg_bytes:
                try:
                    ring["f"].close()
                except OSError:
                    pass
                ring["f"] = None
                ring["seq"] += 1
                self._gc(ring["prefix"])
        if self._metrics is not None:
            self._metrics.counter("history_frames").inc()
            self._metrics.gauge("history_store_bytes").set(
                float(self.bytes_total())
            )
        return True

    def _segments(self, prefix: str) -> List[str]:
        try:
            names = sorted(
                nm for nm in os.listdir(self.directory)
                if nm.startswith(prefix) and nm.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self.directory, nm) for nm in names]

    def bytes_total(self) -> int:
        total = 0
        for p in self._segments(_SEG_PREFIX):
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def _gc(self, prefix: str) -> None:
        """Per-ring bound: drop the OLDEST segments (by mtime, across
        pids) past the ring's budget share — coarse rings age out on
        their own clock instead of being eaten by the 1s firehose."""
        segs = []
        for p in self._segments(prefix):
            try:
                segs.append((os.path.getmtime(p), os.path.getsize(p), p))
            except OSError:
                pass
        segs.sort()
        total = sum(sz for _, sz, _ in segs)
        dropped = 0
        for _, sz, p in segs:
            if total <= self._ring_budget:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= sz
            dropped += 1
        if dropped:
            self._drop("ring_gc", dropped)

    def close(self) -> None:
        with self._mu:
            for ring in self._rings.values():
                if ring["f"] is not None:
                    try:
                        ring["f"].close()
                    except OSError:
                        pass
                    ring["f"] = None


# ---------------------------------------------------------------------------
# Recorder: interval-gated capture + downsampling cascade
# ---------------------------------------------------------------------------


class HistoryRecorder:
    """Periodically captures a registry's cumulative snapshots into
    finest-resolution frames and cascades them through the coarser
    rings (incremental :func:`merge_frames` per pending slot — exact,
    so cascaded coarse frames equal direct downsamples bitwise).
    ``capture_struct`` also accepts EXTERNAL cumulative structs (the
    supervisor feeds its fleet aggregate under ``_fleet``), with
    independent per-source delta state. Accumulated overhead is
    budgeted (``FJT_HISTORY_BUDGET``, default 2%): past it, captures
    drop and are counted (``history_dropped{reason="budget"}``)."""

    def __init__(
        self,
        metrics,
        directory: str,
        src: Optional[str] = None,
        interval_s: Optional[float] = None,
        resolutions: Optional[Tuple[float, ...]] = None,
        max_bytes: Optional[int] = None,
        budget_frac: Optional[float] = None,
        start_thread: bool = True,
    ):
        self._metrics_ref = weakref.ref(metrics)
        self._resolutions = tuple(
            sorted(resolutions or _resolutions_from_env())
        )
        self._finest = self._resolutions[0]
        self.interval_s = float(
            interval_s
            if interval_s is not None
            else _env_float(_INTERVAL_ENV, self._finest)
        )
        self._budget = (
            budget_frac if budget_frac is not None
            else _env_float(_BUDGET_ENV, 0.02)
        )
        self.store = HistoryStore(
            directory,
            metrics=metrics,
            max_bytes=max_bytes,
            resolutions=self._resolutions,
        )
        self.src = (
            src
            if src is not None
            else os.environ.get("FJT_WORKER_ID") or f"pid{os.getpid()}"
        )
        self._mu = threading.Lock()
        self._prev: Dict[str, dict] = {}
        self._pending: Dict[Tuple[str, float], dict] = {}
        self._due = 0.0
        self._t0 = time.monotonic()
        self._overhead_s = 0.0
        self._stop = threading.Event()
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._loop, name="fjt-history", daemon=True
            )
            self._thread.start()

    # -- budget ------------------------------------------------------------

    def overhead_fraction(self) -> float:
        wall = max(time.monotonic() - self._t0, 1e-9)
        return self._overhead_s / wall

    def _over_budget(self) -> bool:
        return self.overhead_fraction() > self._budget

    # -- capture -----------------------------------------------------------

    def maybe_capture(self, now: Optional[float] = None) -> bool:
        """Interval gate + budget gate + capture of the OWN registry.
        Cheap when not due; safe to call from any thread."""
        now = time.time() if now is None else now
        with self._mu:
            if now < self._due:
                return False
            # align due times to the finest grid so multi-source
            # captures land in the same downsample slots
            self._due = (
                math.floor(now / self.interval_s) + 1
            ) * self.interval_s
        metrics = self._metrics_ref()
        if metrics is None:
            return False
        if self._over_budget():
            self.store._drop("budget")
            return False
        struct = metrics.struct_snapshot()
        return self.capture_struct(self.src, struct, now=now) is not None

    def capture_struct(
        self, src: str, struct: dict, now: Optional[float] = None
    ) -> Optional[dict]:
        """Delta the cumulative ``struct`` against the previous capture
        of ``src``, govern it, record capacity-headroom telemetry, and
        persist it through the resolution cascade. Returns the finest
        frame (None on the first capture of a source — no delta yet)."""
        t_start = time.monotonic()
        try:
            now = time.time() if now is None else now
            if not isinstance(struct, dict):
                return None
            with self._mu:
                prev = self._prev.get(src)
                self._prev[src] = struct
                if prev is None:
                    return None
                frame = capture_frame(
                    prev, struct, src=src, res=self._finest,
                    t0=prev.get("ts") or (now - self.interval_s),
                    t1=struct.get("ts") or now,
                )
                self._capacity_telemetry(frame, struct, src)
                frame = govern_frame(frame)
                self.store.append(frame)
                for r in self._resolutions[1:]:
                    slot = math.floor(frame["t0"] / r)
                    p = self._pending.get((src, r))
                    if p is None or p["slot"] != slot:
                        if p is not None:
                            self.store.append(p["acc"])
                        self._pending[(src, r)] = {
                            "slot": slot,
                            "acc": merge_frames([frame], res=r),
                        }
                    else:
                        p["acc"] = merge_frames(
                            [p["acc"], frame], res=r
                        )
            return frame
        finally:
            self._overhead_s += time.monotonic() - t_start

    def _capacity_telemetry(
        self, frame: dict, struct: dict, src: str
    ) -> None:
        """Per-frame capacity headroom: offered load (records_in delta
        over the window, records_out when ingest isn't metered) vs the
        adaptive batcher's fitted capacity (``capacity_rec_s``, its
        latency model) -> ``headroom_frac`` — recorded into the frame
        AND (own source only) the live registry, lazily: no gauge
        exists until a real window is measured, so construction-time
        zeros never poison the fleet MIN."""
        span = max(float(frame["t1"]) - float(frame["t0"]), 1e-9)
        offered = None
        for name in ("records_in", "records_out"):
            v = (frame.get("counters") or {}).get(name)
            if v is not None:
                try:
                    offered = wire_float(v) / span
                except (TypeError, ValueError, ZeroDivisionError):
                    offered = None
                break
        if offered is None:
            return
        gauges = frame.setdefault("gauges", {})
        t1 = float(frame["t1"])

        def _set(name: str, v: float) -> None:
            gauges[name] = {
                "min": v, "max": v, "last": {src: [t1, v]},
            }

        _set("offered_rec_s", offered)
        cap = None
        try:
            g = (struct.get("gauges") or {}).get("capacity_rec_s")
            if g is not None:
                cap = float(g.get("value", 0.0))
        except (AttributeError, TypeError, ValueError):
            cap = None
        headroom = None
        if cap and cap > 0:
            headroom = max(0.0, 1.0 - offered / cap)
            _set("headroom_frac", headroom)
        metrics = self._metrics_ref()
        if metrics is not None and src == self.src:
            metrics.gauge("offered_rec_s").set(offered)
            if headroom is not None:
                metrics.gauge("headroom_frac").set(headroom)

    def flush(self) -> None:
        """Flush pending coarse slots (shutdown / tests). Partial
        coarse frames are safe: a later incarnation's partial frame
        for the same slot MERGES with them at query time — merging is
        the operation everywhere."""
        with self._mu:
            pending, self._pending = self._pending, {}
            for p in pending.values():
                self.store.append(p["acc"])

    # -- lifecycle ---------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(min(self.interval_s * 0.5, 1.0)):
            if self._metrics_ref() is None:
                return
            try:
                self.maybe_capture()
            except Exception:
                pass  # history must never kill its host

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        try:
            self.flush()
        finally:
            self.store.close()


# ---------------------------------------------------------------------------
# Per-registry singletons (the journey-store gating idiom)
# ---------------------------------------------------------------------------

_RECORDERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_RECORDERS_MU = threading.Lock()


def install(metrics, directory: Optional[str] = None, **kw) -> HistoryRecorder:
    """Force-arm a history recorder on a registry (drills, tests, the
    supervisor) regardless of ``FJT_HISTORY_DIR``."""
    rec = _RECORDERS.get(metrics)
    if rec is None:
        with _RECORDERS_MU:
            rec = _RECORDERS.get(metrics)
            if rec is None:
                d = directory or os.environ.get(_DIR_ENV)
                if not d:
                    raise ValueError(
                        "history recorder needs a directory "
                        f"(pass one or set {_DIR_ENV})"
                    )
                rec = _RECORDERS[metrics] = HistoryRecorder(
                    metrics, d, **kw
                )
    return rec


def history_for(metrics) -> Optional[HistoryRecorder]:
    """The gate: the registry's recorder if one is armed, else — with
    ``FJT_HISTORY_DIR`` set — arm one now. Env unset and nothing
    installed: a dict miss + one env lookup and NOTHING records (the
    journey-store contract)."""
    if metrics is None:
        return None
    rec = _RECORDERS.get(metrics)
    if rec is not None:
        return rec
    if not os.environ.get(_DIR_ENV):
        return None
    return install(metrics)


def peek(metrics) -> Optional[HistoryRecorder]:
    """The registry's recorder iff already armed — never arms (the
    ``/history`` endpoint's read path)."""
    if metrics is None:
        return None
    return _RECORDERS.get(metrics)


# ---------------------------------------------------------------------------
# Read side: directory scan, range queries, /history payloads
# ---------------------------------------------------------------------------


def read_frames(
    directory: str,
    res: Optional[float] = None,
    start: Optional[float] = None,
    end: Optional[float] = None,
    sources: Optional[Iterable[str]] = None,
    limit: int = 200000,
) -> List[dict]:
    """Frames retained in ``directory`` (all pids, all incarnations),
    filtered and sorted by ``(t0, src)``. Torn trailing lines are
    skipped — SIGKILL tears at most the unflushed tail."""
    srcs = set(sources) if sources is not None else None
    out: List[dict] = []
    try:
        names = [
            nm for nm in os.listdir(directory)
            if nm.startswith(_SEG_PREFIX) and nm.endswith(".jsonl")
        ]
    except OSError:
        return []
    for nm in sorted(names):
        for f in iter_jsonl(os.path.join(directory, nm)):
            try:
                ft0, ft1 = float(f.get("t0", 0.0)), float(f.get("t1", 0.0))
                fres = float(f.get("res", 0.0))
            except (TypeError, ValueError):
                continue
            if res is not None and fres != float(res):
                continue
            if start is not None and ft1 < float(start):
                continue
            if end is not None and ft0 > float(end):
                continue
            fsrc = str(f.get("src", ""))
            if srcs is not None:
                if fsrc not in srcs:
                    continue
            elif fsrc == FLEET_SRC:
                continue  # the aggregate double-counts worker sources
            out.append(f)
            if len(out) >= limit:
                break
    out.sort(key=lambda f: (float(f.get("t0", 0.0)), str(f.get("src", ""))))
    return out


def resolutions_in(directory: str) -> List[float]:
    res = set()
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for nm in names:
        if not (nm.startswith(_SEG_PREFIX) and nm.endswith(".jsonl")):
            continue
        tag = nm[len(_SEG_PREFIX):].split("-", 1)[0]
        if tag.endswith("s"):
            try:
                res.add(float(tag[:-1].replace("p", ".")))
            except ValueError:
                pass
    return sorted(res)


def _match_names(names: Optional[List[str]], candidate: str) -> bool:
    if not names:
        return True
    from fnmatch import fnmatch

    return any(fnmatch(candidate, pat) for pat in names)


def query(
    directory: str,
    names: Optional[List[str]] = None,
    start: Optional[float] = None,
    end: Optional[float] = None,
    step: Optional[float] = None,
    sources: Optional[List[str]] = None,
) -> dict:
    """Range query: pick the coarsest stored resolution <= ``step``
    (the cheapest frames that still resolve the ask), merge each
    ``step`` window across sources, optionally project to ``names``
    (fnmatch patterns). The returned frames keep the exact wire
    encoding; :func:`frame_to_struct` renders them."""
    avail = resolutions_in(directory)
    res = None
    if avail:
        if step:
            fitting = [r for r in avail if r <= float(step)]
            res = max(fitting) if fitting else min(avail)
        else:
            res = min(avail)
    frames = read_frames(
        directory, res=res, start=start, end=end, sources=sources
    )
    eff_step = float(step) if step else (res or 0.0)
    if frames and eff_step > 0:
        frames = downsample(frames, eff_step)
        if start is not None:
            frames = [f for f in frames if f["t1"] >= float(start)]
        if end is not None:
            frames = [f for f in frames if f["t0"] <= float(end)]
    if names:
        projected = []
        for f in frames:
            g = dict(f)
            for section in ("counters", "gauges", "histograms"):
                g[section] = {
                    n: v
                    for n, v in (f.get(section) or {}).items()
                    if _match_names(names, n)
                }
            projected.append(g)
        frames = projected
    series: Dict[str, List[list]] = {}
    if names:
        for f in frames:
            t_mid = (float(f["t0"]) + float(f["t1"])) / 2.0
            for n, v in (f.get("counters") or {}).items():
                try:
                    series.setdefault(n, []).append(
                        [t_mid, wire_float(v)]
                    )
                except (TypeError, ValueError, ZeroDivisionError):
                    pass
            for n, g in (f.get("gauges") or {}).items():
                try:
                    series.setdefault(n, []).append(
                        [t_mid, combined_last(n, g.get("last"))]
                    )
                except (AttributeError, TypeError, ValueError):
                    pass
            for n, st in (f.get("histograms") or {}).items():
                try:
                    series.setdefault(n + "_n", []).append(
                        [t_mid, float(st.get("n", 0))]
                    )
                except (AttributeError, TypeError, ValueError):
                    pass
    payload = {
        "dir": directory,
        "res": res,
        "step": eff_step or None,
        "start": start,
        "end": end,
        "sources": sources,
        "resolutions": avail,
        "frames": frames,
    }
    if series:
        payload["series"] = series
    return payload


def query_params(params: dict) -> dict:
    """Decode a parsed query string (``urllib.parse.parse_qs`` shape —
    values are lists) into :func:`query` kwargs."""
    def _one(key):
        v = params.get(key)
        return v[0] if isinstance(v, (list, tuple)) and v else v

    def _f(key):
        v = _one(key)
        if v in (None, ""):
            return None
        try:
            return float(v)
        except (TypeError, ValueError):
            return None

    names = _one("name")
    sources = _one("source")
    return {
        "names": (
            [p for p in str(names).split(",") if p] if names else None
        ),
        "sources": (
            [p for p in str(sources).split(",") if p] if sources else None
        ),
        "start": _f("start"),
        "end": _f("end"),
        "step": _f("step"),
    }


def history_payload(metrics=None, params: Optional[dict] = None) -> dict:
    """The ``/history`` endpoint's JSON: the armed recorder's (or env)
    directory queried with the request's range/step/name selector."""
    rec = peek(metrics) if metrics is not None else None
    d = rec.store.directory if rec is not None else os.environ.get(_DIR_ENV)
    if rec is not None:
        # serve the freshest picture: pending coarse slots flush and
        # an interval-due capture happens before the read
        try:
            rec.maybe_capture()
        except Exception:
            pass
    if not d:
        return {"dir": None, "resolutions": [], "frames": []}
    return query(d, **query_params(params or {}))
