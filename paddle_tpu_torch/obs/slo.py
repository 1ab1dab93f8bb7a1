"""Declarative SLOs + multi-window burn-rate alerting over the history ring.

The port's copy of paddle_tpu/obs/slo.py (stdlib only).

The wedge watchdogs (serving/pserver/router) only freeze a postmortem
bundle when a thread has *already* stopped making progress.  This module
is the earlier tripwire: declarative SLO specs evaluated over the
`obs/timeseries.py` ring, multi-window SRE style — an objective is
"burning" in a window when the fraction of resolution windows that
violated it reaches `burn_threshold`, and a spec FIRES only when both
the short and the long window burn (a transient blip trips neither; a
sustained regression trips both).  Clearing needs only the short window
to recover, so alerts shut off quickly once the fleet is healthy.

On a firing transition the evaluator

  * records an `slo_fire` flight event (and `slo_clear` on recovery),
  * flips the `obs_slo_firing{slo=...}` gauge (and counts the
    transition in `obs_slo_fired_total`),
  * freezes at most ONE postmortem bundle per episode through the same
    re-arm shape as the wedge watchdogs: the dump hook runs when the
    fleet goes from "no SLOs firing" to "some SLO firing", and re-arms
    only when ALL specs have cleared — so degradation produces a bundle
    with the offending series attached *before* anything dies.

Spec kinds:

  * "gauge"     — `series` is one gauge key; each stored point is
                  compared against the objective (p99 TTFT/ITL ride
                  the StatSet quantile gauges this way).
  * "ratio"     — `series`/`den` are counter keys (tuples are summed);
                  per window, ratio = sum(num deltas)/sum(den deltas),
                  and windows with zero denominator are SKIPPED — no
                  traffic burns no budget (an idle fleet never pages).
  * "hist_mean" — sugar over "ratio" for a catalogued histogram:
                  per-window mean = `<series>_sum` / `<series>_count`.

Evaluation runs on the HistorySampler thread right after each sampling
pass; it reads the ring under its lock and touches nothing the pump
owns.  Stdlib-only, like the rest of `obs/`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from paddle_tpu_torch.obs.timeseries import MetricHistory


@dataclass
class SloSpec:
    """One declarative objective over the history ring."""

    #: identity — the `slo` label value on obs_slo_firing and the
    #: flight-event payload
    name: str
    #: series key ("gauge"/"hist_mean") or numerator key(s) ("ratio")
    series: object = ""
    #: the objective the windowed value is compared against
    objective: float = 0.0
    #: fires when value OP objective — ">" (latency/skew/shed style) or
    #: "<" (accept-rate/hit-rate style)
    op: str = ">"
    kind: str = "gauge"          # "gauge" | "ratio" | "hist_mean"
    #: ratio denominators (counter keys, summed)
    den: tuple = ()
    short_window_s: float = 60.0
    long_window_s: float = 300.0
    #: fraction of evaluated windows that must violate to burn
    burn_threshold: float = 0.5
    description: str = ""

    def __post_init__(self):
        if self.op not in (">", "<"):
            raise ValueError(f"slo {self.name!r}: op must be '>' or '<'")
        if self.kind not in ("gauge", "ratio", "hist_mean"):
            raise ValueError(f"slo {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.kind == "ratio" and not self.den:
            raise ValueError(f"slo {self.name!r}: ratio needs den")
        if self.long_window_s < self.short_window_s:
            raise ValueError(f"slo {self.name!r}: long window shorter "
                             f"than short window")

    def _num_keys(self) -> tuple:
        if self.kind == "hist_mean":
            return (f"{self.series}_sum",)
        return (self.series,) if isinstance(self.series, str) \
            else tuple(self.series)

    def _den_keys(self) -> tuple:
        if self.kind == "hist_mean":
            return (f"{self.series}_count",)
        return tuple(self.den)


class SloEvaluator:
    """Evaluates SloSpecs against a MetricHistory; owns the per-spec
    firing state and the one-bundle-per-episode dump re-arm."""

    def __init__(self, history: MetricHistory, specs, *, flight=None,
                 registry=None, dump_fn=None):
        self.history = history
        self.specs = list(specs)
        self.flight = flight
        self.dump_fn = dump_fn
        self._firing = {s.name: False for s in self.specs}
        self._last = {}              # spec name -> last windowed value
        self._dumped = False         # one bundle per episode (re-arm
        self._gauge = None           # when ALL specs clear)
        self._counter = None
        if registry is not None and self.specs:
            self._gauge = registry.gauge("obs_slo_firing",
                                         labels=("slo",))
            self._counter = registry.counter("obs_slo_fired_total",
                                             labels=("slo",))
            for s in self.specs:
                self._gauge.set(0.0, slo=s.name)
                self._counter.inc(0.0, slo=s.name)

    # -- reading -----------------------------------------------------------
    def firing(self) -> list[str]:
        return sorted(n for n, f in self._firing.items() if f)

    def status(self) -> list[dict]:
        return [{"slo": s.name, "firing": self._firing[s.name],
                 "objective": s.objective, "op": s.op,
                 "value": self._last.get(s.name),
                 "description": s.description} for s in self.specs]

    # -- evaluation (sampler thread) ---------------------------------------
    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """One pass over every spec; returns the firing transitions
        ([{"slo", "event", ...}]).  Runs the dump hook on the first fire
        of an episode, AFTER recording the slo_fire event so the bundle
        carries it."""
        now = time.time() if now is None else float(now)
        transitions = []
        first = self.history.first_sample_unix
        for spec in self.specs:
            # warm-up gate: a spec cannot claim its long window burned
            # until the ring has actually covered one — five seconds of
            # uptime is not five minutes of evidence.  (Clearing is
            # never gated; an armed spec may always recover.)
            if not self._firing[spec.name] and \
                    (first == 0.0 or now - first < spec.long_window_s):
                continue
            short = self._burn(spec, spec.short_window_s, now)
            long_ = self._burn(spec, spec.long_window_s, now)
            if short is not None:
                self._last[spec.name] = short[1]
            was = self._firing[spec.name]
            if not was and short is not None and long_ is not None \
                    and short[0] >= spec.burn_threshold \
                    and long_[0] >= spec.burn_threshold:
                self._firing[spec.name] = True
                t = {"slo": spec.name, "event": "slo_fire",
                     "short_burn": round(short[0], 4),
                     "long_burn": round(long_[0], 4),
                     "value": short[1], "objective": spec.objective,
                     "op": spec.op, "series": spec._num_keys()}
                transitions.append(t)
                if self._gauge is not None:
                    self._gauge.set(1.0, slo=spec.name)
                    self._counter.inc(1.0, slo=spec.name)
                if self.flight is not None:
                    self.flight.record(
                        "slo_fire", slo=spec.name,
                        value=short[1], objective=spec.objective,
                        op=spec.op, short_burn=round(short[0], 4),
                        long_burn=round(long_[0], 4),
                        series=",".join(spec._num_keys()))
            elif was and (short is None
                          or short[0] < spec.burn_threshold):
                self._firing[spec.name] = False
                transitions.append({"slo": spec.name,
                                    "event": "slo_clear",
                                    "value": None if short is None
                                    else short[1]})
                if self._gauge is not None:
                    self._gauge.set(0.0, slo=spec.name)
                if self.flight is not None:
                    self.flight.record(
                        "slo_clear", slo=spec.name,
                        value=None if short is None else short[1])
        # wedge-style episode re-arm: dump once when the fleet enters a
        # firing episode, re-arm only once everything has cleared
        if any(self._firing.values()):
            if not self._dumped:
                self._dumped = True
                if self.dump_fn is not None:
                    fired = [t for t in transitions
                             if t["event"] == "slo_fire"]
                    self.dump_fn(fired or
                                 [{"slo": n, "event": "slo_fire"}
                                  for n in self.firing()])
        else:
            self._dumped = False
        return transitions

    def _burn(self, spec: SloSpec, window_s: float, now: float):
        """(violated_fraction, last_windowed_value) over the trailing
        `window_s`, or None when no window could be evaluated (no data,
        or — for ratios — no traffic)."""
        if spec.kind == "gauge":
            pts = self.history.points(spec.series, last_s=window_s,
                                      now=now)
            vals = [v for _, v in pts]
        else:
            num: dict = {}
            den: dict = {}
            for k in spec._num_keys():
                for t, v in self.history.points(k, last_s=window_s,
                                                now=now):
                    num[t] = num.get(t, 0.0) + v
            for k in spec._den_keys():
                for t, v in self.history.points(k, last_s=window_s,
                                                now=now):
                    den[t] = den.get(t, 0.0) + v
            vals = [num.get(t, 0.0) / d
                    for t, d in sorted(den.items()) if d > 0]
        if not vals:
            return None
        if spec.op == ">":
            bad = sum(1 for v in vals if v > spec.objective)
        else:
            bad = sum(1 for v in vals if v < spec.objective)
        return bad / len(vals), vals[-1]


# -- default objectives ------------------------------------------------------
# Thresholds are deliberately loose operational defaults: they page on a
# collapse, not on noise.  Deployments tune them via the server
# constructors' `slo_specs=` (pass () to disable alerting entirely).

def default_serving_slos() -> list:
    q = 'serving_latency_seconds{quantile="p99",stat="%s"}'
    return [
        SloSpec(name="serving_ttft_p99", series=q % "first_token_latency",
                objective=2.0, op=">",
                description="p99 time-to-first-token under 2s"),
        SloSpec(name="serving_itl_p99", series=q % "token_latency",
                objective=0.5, op=">",
                description="p99 inter-token latency under 500ms"),
        SloSpec(name="serving_shed_ratio", kind="ratio",
                series=("serving_overload_total",),
                den=("serving_requests_accepted_total",
                     "serving_overload_total"),
                objective=0.05, op=">",
                description="under 5% of arrivals shed with overload"),
        SloSpec(name="serving_spec_accept", kind="ratio",
                series=("serving_spec_accepted_total",),
                den=("serving_spec_drafted_total",),
                objective=0.2, op="<",
                description="speculative accept rate above 0.2 while "
                            "drafting (idle windows never burn)"),
        SloSpec(name="serving_prefix_hit", kind="ratio",
                series=("serving_prefix_hits_total",),
                den=("serving_prefix_hits_total",
                     "serving_prefix_misses_total"),
                objective=0.05, op="<",
                description="prefix-cache hit rate above 5% while "
                            "admitting (idle windows never burn)"),
    ]


def default_router_slos() -> list:
    return [
        SloSpec(name="fleet_shed_ratio", kind="ratio",
                series=("fleet_sheds_total",),
                den=("fleet_requests_accepted_total",
                     "fleet_sheds_total"),
                objective=0.05, op=">",
                description="under 5% of fleet arrivals shed"),
        SloSpec(name="fleet_replicas_healthy",
                series="fleet_replicas_healthy", objective=1.0, op="<",
                description="at least one healthy replica registered"),
    ]


def default_pserver_slos() -> list:
    return [
        SloSpec(name="pserver_window_skew", kind="hist_mean",
                series="pserver_window_skew_ms", objective=1000.0,
                op=">",
                description="mean per-window barrier-arrival skew "
                            "under 1s (straggler alarm)"),
    ]
