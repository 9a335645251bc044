"""Measurement- and reported-covariance calibration from a logged run.

A copy of ``cuahn_vio.eval.calibration`` (numpy only):

- ``fit_k_net_cov`` / ``fit_from_state_npz`` (``calibrate-covariance``):
  the reference trusts the network covariance through one hand-tuned
  scalar, R = K_net_Cov * Σ_net / 159.5² with K_net_Cov = 10.0
  (UpdaterHNet.cpp:31-33). Given the per-frame innovation log of
  ``run-vio --state-out`` (innovation e, propagated H P Hᵀ, raw Σ_net),
  chi2(k) = eᵀ (H P Hᵀ + k Σ_net / 159.5²)⁻¹ e decreases in k, so the k
  whose median chi2 hits the 8-DoF chi-square median (7.3441) is found by
  bisection in log space. The log was made under the old k, which fed
  back into H P Hᵀ: run, fit, re-run with the fitted k, check the median.
- ``fit_cov_inflation`` (``calibrate-state-covariance``): per-block
  factors of the reported covariance (``run-vio --cov-calib``) whose
  observable-subspace NEES medians hit their chi-square ideals.
- ``inflation_diag`` / ``apply_cov_inflation``: the per-block inflation
  ``P' = D P D`` of the output covariance (``run-vio --cov-calib``).
- ``recorded_inflation``: the factors a port ``--state-out`` log records
  when its covariance was already inflated (the JAX log records none).
"""

from __future__ import annotations

import numpy as np

FOCAL2 = 159.5 * 159.5
CHI2_8_MEDIAN = 7.3441  # chi-square 8-DoF distribution median


def chi2_for_k(
    inno: np.ndarray,  # (F, 8)
    cov_meas: np.ndarray,  # (F, 8, 8)
    net_cov88: np.ndarray,  # (F, 8, 8) pixels^2
    k: float,
) -> np.ndarray:
    """Per-frame innovation chi2 under measurement-cov temperature ``k``."""
    s = cov_meas + k * net_cov88 / FOCAL2
    sol = np.linalg.solve(s, inno[..., None])[..., 0]
    return np.einsum("fi,fi->f", inno, sol)


def _valid_rows(inno, cov_meas, net_cov88):
    finite = (
        np.isfinite(inno).all(axis=1)
        & np.isfinite(cov_meas).all(axis=(1, 2))
        & np.isfinite(net_cov88).all(axis=(1, 2))
    )
    # rows from gated / pre-update frames log zero matrices — unusable
    nonzero = np.einsum("fii->f", net_cov88) > 0
    return finite & nonzero


def fit_k_net_cov(
    inno: np.ndarray,
    cov_meas: np.ndarray,
    net_cov88: np.ndarray,
    target_median: float = CHI2_8_MEDIAN,
    lo: float = 1e-3,
    hi: float = 1e5,
    iters: int = 60,
) -> dict:
    """Bisection fit of the covariance temperature; returns a stats dict."""
    keep = _valid_rows(inno, cov_meas, net_cov88)
    inno, cov_meas, net_cov88 = inno[keep], cov_meas[keep], net_cov88[keep]
    if len(inno) < 10:
        raise ValueError(f"only {len(inno)} usable frames in the log")

    def med(k):
        return float(np.median(chi2_for_k(inno, cov_meas, net_cov88, k)))

    if med(lo) < target_median:  # even the floor over-covers
        k_fit = lo
    elif med(hi) > target_median:
        k_fit = hi
    else:
        a, b = lo, hi
        for _ in range(iters):
            m = np.sqrt(a * b)  # k spans decades: bisect in log space
            if med(m) > target_median:
                a = m
            else:
                b = m
        k_fit = float(np.sqrt(a * b))

    c = chi2_for_k(inno, cov_meas, net_cov88, k_fit)
    return {
        "k_net_cov": k_fit,
        "n_frames": int(len(inno)),
        "chi2_median": float(np.median(c)),
        "chi2_p95": float(np.percentile(c, 95)),
        "chi2_mean": float(np.mean(c)),
        "target_median": target_median,
    }


def fit_from_state_npz(path: str, **kw) -> dict:
    """Fit from a ``run-vio --state-out`` npz (needs the round-2 calibration
    arrays net_inno/cov_meas/net_cov88)."""
    d = np.load(path)
    for key in ("net_inno", "cov_meas", "net_cov88"):
        if key not in d:
            raise ValueError(
                f"{path} lacks '{key}' — re-run run-vio --state-out with a "
                "round-2 build"
            )
    return fit_k_net_cov(d["net_inno"], d["cov_meas"], d["net_cov88"], **kw)


# ---------------------------------------------------------------- NEES calib
COV_BLOCKS = ("pos", "ori", "vel", "ba", "bg")


def inflation_diag(factors: dict, dtype=np.float32) -> np.ndarray:
    """(15,) sqrt-factor diagonal D for P' = D P D from per-block variance
    factors {pos, ori, vel, ba, bg} (missing -> 1). D P D scales each
    block's variance by its factor and cross blocks by the geometric mean,
    preserving positive-definiteness exactly."""
    d = np.ones(15, dtype)
    for i, name in enumerate(COV_BLOCKS):
        d[3 * i : 3 * i + 3] = np.sqrt(float(factors.get(name, 1.0)))
    return d


def apply_cov_inflation(cov_core: np.ndarray, factors: dict) -> np.ndarray:
    """Apply D P D to a (..., 15, 15) covariance stack."""
    d = inflation_diag(factors, cov_core.dtype)
    return cov_core * d[:, None] * d[None, :]


def recorded_inflation(d) -> dict | None:
    """{block: factor} that ``run-vio --cov-calib`` applied to the
    covariance of a loaded ``--state-out`` npz ``d``, or None when it
    records none (no ``--cov-calib``, or a JAX log)."""
    if "cov_calib_factors" not in d:
        return None
    names = d["cov_calib_blocks"] if "cov_calib_blocks" in d else COV_BLOCKS
    return {str(k): float(v) for k, v in zip(names, d["cov_calib_factors"])}


def fit_cov_inflation(
    state_npz: str,
    state_gt_path: str,
    targets: dict | None = None,
    iters: int = 4,
) -> dict:
    """Fit per-block REPORTED-covariance inflation factors so the
    observable-subspace NEES medians hit their chi-square ideals.

    Motivation (rounds 4-5, benchmarks/results/round5/experiments.md): the
    filter's internal covariance is ~5x optimistic in the observable
    directions because the network's error violates the white-noise
    measurement model (prior echo ~0.5, heavy tails), and every mechanism
    that restores consistency THROUGH THE GAIN (R temperature, adaptive R,
    bias-state augmentation, echo-aware H, NEES-trained covariance head)
    measurably degrades ATE — the optimistic gain is the accurate gain.
    The standard resolution is covariance CALIBRATION: keep the internal
    gain, calibrate the REPORTED covariance (the quantity ov_eval's NEES
    checks and downstream consumers use). Factors are fit on a
    calibration sequence and must be applied UNCHANGED to evaluation
    sequences (run-vio --cov-calib).

    Iterative because height NEES mixes the pos and ori blocks; 3-4
    fixed-point rounds converge to <1%.
    """
    from cuahn_vio_torch.eval.simulation import ResultSimulation, load_state_gt

    targets = targets or {"height": 1.0, "tilt": 2.0, "vel": 3.0}
    d = np.load(state_npz)
    gt = load_state_gt(state_gt_path)
    factors = {"pos": 1.0, "ori": 1.0, "vel": 1.0}
    for _ in range(iters):
        cov = apply_cov_inflation(d["cov_core"], factors)
        sim = ResultSimulation(
            d["times"], d["pose"], gt,
            est_v_body=d["v_body"], est_ba=d["ba"], est_bg=d["bg"],
            est_cov_diag=np.einsum("fii->fi", cov), est_cov_core=cov,
        )
        nees = sim.calculate_nees_observable()
        factors = {
            "pos": factors["pos"] * max(nees["height"].median / targets["height"], 1e-3),
            "ori": factors["ori"] * max(nees["tilt"].median / targets["tilt"], 1e-3),
            "vel": factors["vel"] * max(nees["vel"].median / targets["vel"], 1e-3),
        }
    return {k: float(v) for k, v in factors.items()}
