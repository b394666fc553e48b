"""Queueing-theoretic analysis of the ICC tandem network (paper §III).

The offload path is modeled as a tandem queueing network (paper Fig. 3):

    Poisson(lambda) arrivals
      -> M/M/1 air-interface queue, service rate mu1
      -> constant wireline hop t_wireline
      -> M/M/1 compute queue, service rate mu2

By Burke's theorem the departure process of the first M/M/1 queue is
Poisson(lambda), so the compute queue is itself M/M/1, and the sojourn
times of a tagged job in the two queues are *independent* (paper Lemma 1).
The sojourn time of an M/M/1 queue with arrival rate lambda and service
rate mu is Exp(mu - lambda).

Everything here is exact closed form; `tests/test_queueing.py` cross-checks
against Monte-Carlo simulation of the actual tandem queue.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = [
    "ICCSystem",
    "exp_cdf",
    "exp_quantile",
    "exp_sum_cdf",
    "sojourn_cdf",
    "ks_distance",
    "joint_satisfaction",
    "disjoint_satisfaction",
    "service_capacity",
]


@dataclasses.dataclass(frozen=True)
class ICCSystem:
    """Parameters of the tandem ICC queueing system (paper §III-A).

    Rates are jobs/second; latencies are seconds.
    """

    mu1: float  # air-interface service rate (jobs/s)
    mu2: float  # compute service rate (jobs/s)
    t_wireline: float  # constant BS -> computing-node latency (s)

    def stable(self, lam: float) -> bool:
        return 0.0 <= lam < min(self.mu1, self.mu2)


def exp_sum_cdf(a: float, b: float, t: float) -> float:
    """P(X + Y <= t) for independent X ~ Exp(a), Y ~ Exp(b); a, b > 0.

    Hypoexponential CDF. Handles the a == b (Erlang-2) limit and is
    numerically stable for a ~ b via a series fallback.

    The port clamps the a != b branch to [0, 1]: near t = 0 the
    cancellation in ``1 - (b e^-at - a e^-bt) / (b - a)`` can leave a
    value just below 0 (-2.2e-16 at t = 2.2e-16, a = 5, b = 8.5, in the
    reference). Inside [0, 1] the value is the reference's, bit for bit.
    """
    if t <= 0.0:
        return 0.0
    if a <= 0.0 or b <= 0.0:
        raise ValueError(f"rates must be positive, got a={a}, b={b}")
    if abs(a - b) <= 1e-9 * max(a, b):
        # Erlang-2 limit: 1 - e^{-at}(1 + at), evaluated at the mean rate.
        r = 0.5 * (a + b)
        return -math.expm1(-r * t) - r * t * math.exp(-r * t)
    p = 1.0 - (b * math.exp(-a * t) - a * math.exp(-b * t)) / (b - a)
    return min(1.0, max(0.0, p))


def exp_cdf(rate: float, t: float) -> float:
    """P(X <= t) for X ~ Exp(rate): the M/M/1 sojourn-time CDF at rate
    mu - lambda. Public because the telemetry conformance validator
    compares measured sojourn samples against it."""
    if t <= 0.0:
        return 0.0
    return -math.expm1(-rate * t)


# internal alias kept for the satisfaction closed forms below
_exp_cdf = exp_cdf


def exp_quantile(rate: float, q: float) -> float:
    """Inverse of `exp_cdf`: the q-quantile of Exp(rate). Tolerance bands
    in the conformance report are expressed at these quantiles."""
    if not 0.0 <= q < 1.0:
        raise ValueError(f"q must be in [0, 1), got {q}")
    if rate <= 0.0:
        raise ValueError(f"rate must be positive, got {rate}")
    return -math.log1p(-q) / rate


def sojourn_cdf(sys: ICCSystem, lam: float, stage: str, t: float) -> float:
    """Closed-form sojourn-time CDF of a tagged job at offered load `lam`
    (paper Lemma 1: the two M/M/1 sojourns are independent exponentials).

    ``stage`` selects which latency the CDF describes:

      comm   air-interface sojourn            ~ Exp(mu1 - lam)
      comp   compute-queue sojourn            ~ Exp(mu2 - lam)
      e2e    comm + wireline + comp           (hypoexponential, shifted
             by the constant t_wireline)
    """
    if not sys.stable(lam):
        raise ValueError(f"system unstable at lam={lam}")
    if stage == "comm":
        return exp_cdf(sys.mu1 - lam, t)
    if stage == "comp":
        return exp_cdf(sys.mu2 - lam, t)
    if stage == "e2e":
        return exp_sum_cdf(sys.mu1 - lam, sys.mu2 - lam, t - sys.t_wireline)
    raise ValueError(f"unknown stage {stage!r}; use comm/comp/e2e")


def ks_distance(samples, cdf) -> float:
    """Kolmogorov-Smirnov distance sup_t |F_emp(t) - F(t)| between an
    empirical sample and a model CDF callable.

    The sup over a continuous F against a right-continuous step function
    is attained at a sample point, approached from one side or the other,
    so it suffices to evaluate F at the sorted samples. This is the
    tolerance metric of the analytic-conformance check (paper Fig. 4 as a
    permanent self-test): under H0 the statistic concentrates around
    ~1.36/sqrt(n) at the 95% level."""
    xs = sorted(float(x) for x in samples)
    n = len(xs)
    if n == 0:
        raise ValueError("ks_distance needs at least one sample")
    d = 0.0
    for i, x in enumerate(xs):
        f = cdf(x)
        d = max(d, abs((i + 1) / n - f), abs(i / n - f))
    return d


def joint_satisfaction(sys: ICCSystem, lam: float, b_total: float) -> float:
    """P(job satisfied) under *joint* latency management (paper Eq. 3).

    Success iff T_comm^{UE-BS} + T_comp <= b_total - t_wireline, with the
    two sojourn times independent Exp(mu1-lam), Exp(mu2-lam).
    """
    if not sys.stable(lam):
        return 0.0
    t = b_total - sys.t_wireline
    return exp_sum_cdf(sys.mu1 - lam, sys.mu2 - lam, t)


def disjoint_satisfaction(
    sys: ICCSystem,
    lam: float,
    b_total: float,
    b_comm: float,
    b_comp: float,
) -> float:
    """P(job satisfied) under *disjoint* latency management (paper Eq. 4).

    Success iff all of:
        X + Y <= c     (end-to-end)      c  = b_total - t_wireline
        X     <= c1    (comm sub-budget) c1 = b_comm  - t_wireline
        Y     <= c2    (comp sub-budget) c2 = b_comp
    with X ~ Exp(a), Y ~ Exp(b) independent, a = mu1-lam, b = mu2-lam.

    Closed form: integrate f_X(x) * F_Y(min(c2, c-x)) over [0, min(c1, c)],
    splitting at x0 = c - c2 where the inner min switches branch.
    """
    if not sys.stable(lam):
        return 0.0
    a = sys.mu1 - lam
    b = sys.mu2 - lam
    c = b_total - sys.t_wireline
    c1 = b_comm - sys.t_wireline
    c2 = b_comp
    m = min(c1, c)
    if m <= 0.0 or c2 <= 0.0 or c <= 0.0:
        return 0.0

    x0 = c - c2  # for x <= x0 the Y-budget binds at c2; above, at c - x.
    lo_end = min(max(x0, 0.0), m)

    # Segment 1: x in [0, lo_end], F_Y = F_Y(c2) constant.
    p = _exp_cdf(a, lo_end) * _exp_cdf(b, c2)

    # Segment 2: x in [lo_end, m], F_Y = 1 - e^{-b(c-x)}.
    if m > lo_end:
        # ∫ a e^{-ax} (1 - e^{-b(c-x)}) dx
        p += _exp_cdf(a, m) - _exp_cdf(a, lo_end)
        if abs(a - b) <= 1e-9 * max(a, b):
            # ∫ a e^{-ax} e^{-b(c-x)} dx -> a e^{-bc} (m - lo_end) at a == b
            p -= a * math.exp(-b * c) * (m - lo_end)
        else:
            p -= (
                a
                * math.exp(-b * c)
                / (b - a)
                * (math.exp((b - a) * m) - math.exp((b - a) * lo_end))
            )
    return min(max(p, 0.0), 1.0)


def service_capacity(
    satisfaction_fn,
    mu_max: float,
    alpha: float = 0.95,
    tol: float = 1e-6,
) -> float:
    """Service capacity lambda* (paper Def. 2) by bisection.

    `satisfaction_fn(lam)` must be non-increasing in lam (it is for both
    joint and disjoint management: heavier load only slows queues).
    Returns sup{lam : satisfaction_fn(lam) >= alpha}, or 0.0 if even
    lam -> 0 misses the target.
    """
    if satisfaction_fn(tol) < alpha:
        return 0.0
    lo, hi = tol, mu_max - tol
    if satisfaction_fn(hi) >= alpha:
        return hi
    while hi - lo > tol * mu_max:
        mid = 0.5 * (lo + hi)
        if satisfaction_fn(mid) >= alpha:
            lo = mid
        else:
            hi = mid
    return lo


def paper_fig4_setup() -> dict:
    """The exact §III-B scenario: mu1=900/s, mu2=100/s, b_total=80 ms.

    Returns the three schemes compared in Fig. 4 as
    {name: (system, satisfaction_fn(lam))}.
    """
    b_total = 0.080
    ran = ICCSystem(mu1=900.0, mu2=100.0, t_wireline=0.005)
    mec = ICCSystem(mu1=900.0, mu2=100.0, t_wireline=0.020)
    return {
        "joint_ran": (ran, lambda lam: joint_satisfaction(ran, lam, b_total)),
        "disjoint_ran": (
            ran,
            lambda lam: disjoint_satisfaction(ran, lam, b_total, 0.024, 0.056),
        ),
        "disjoint_mec": (
            mec,
            lambda lam: disjoint_satisfaction(mec, lam, b_total, 0.024, 0.056),
        ),
    }
