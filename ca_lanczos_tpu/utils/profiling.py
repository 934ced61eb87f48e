"""Kernel profiling and roofline audit.

The reference only collects wall-clock (cputime / tic-toc,
test_ca_lanczos.m:26-42, runLanczos.m:66-131).  The north star requires a
per-kernel roofline audit (nnz/s, bytes/flop) — this module provides:

* ``PEAK_HBM_BW`` / ``peak_hbm_bw`` — published device-memory bandwidth
  keyed by ``jax.Device.device_kind``; an unknown device is an error.
* ``roofline_audit`` — analytic traffic/flop model for the matrix-powers
  step on a DIA operator + a measured throughput -> fraction-of-peak.
* ``measure_powers_throughput`` / ``measure_ca_iteration_throughput`` —
  device timing of chained work inside one jit, fenced with
  ``block_until_ready``.
* ``trace`` — context manager around jax.profiler for TensorBoard traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ca_lanczos_tpu.ops.precision import mm
from ca_lanczos_tpu.ops.spmv import DiaMatrix

# Published peak device-memory bandwidth, bytes/s, keyed by
# jax.Device.device_kind (NVIDIA data sheets: H100 SXM 3.35 TB/s, H100
# PCIe 2.0 TB/s, H200 SXM 4.8 TB/s).  Achievable rates are lower; compare
# a kernel with a copy measured in the same process as well.
PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H200": 4.8e12,
}


def peak_hbm_bw(device_kind: str) -> float:
    """Published memory bandwidth of ``device_kind``; raises KeyError for
    a device the table does not know (no silent default)."""
    try:
        return PEAK_HBM_BW[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory bandwidth for device kind {device_kind!r}; "
            f"known: {sorted(PEAK_HBM_BW)}"
        ) from None


@dataclasses.dataclass
class RooflineReport:
    nnz: int
    bytes_per_step: int
    flops_per_step: int
    arithmetic_intensity: float  # flop / byte
    sol_nnz_per_s: float  # memory-bandwidth speed-of-light
    measured_nnz_per_s: Optional[float] = None
    fraction_of_peak: Optional[float] = None

    def __str__(self) -> str:
        lines = [
            f"nnz/step            : {self.nnz:,}",
            f"bytes/step          : {self.bytes_per_step:,}",
            f"flops/step          : {self.flops_per_step:,}",
            f"arith intensity     : {self.arithmetic_intensity:.3f} flop/B (memory-bound)",
            f"speed of light      : {self.sol_nnz_per_s / 1e9:.1f} Gnnz/s",
        ]
        if self.measured_nnz_per_s is not None:
            lines.append(f"measured            : {self.measured_nnz_per_s / 1e9:.1f} Gnnz/s")
            lines.append(f"fraction of peak    : {100 * self.fraction_of_peak:.1f}%")
        return "\n".join(lines)


def roofline_audit(
    A: DiaMatrix,
    measured_nnz_per_s: Optional[float] = None,
    hbm_bw: Optional[float] = None,
) -> RooflineReport:
    """Traffic model of one DIA matrix-powers step: read all diagonals +
    the vector, write the result; 2 flops per stored element.  ``hbm_bw``
    defaults to the published peak of the first JAX device."""
    if hbm_bw is None:
        hbm_bw = peak_hbm_bw(jax.devices()[0].device_kind)
    itemsize = jnp.dtype(A.dtype).itemsize
    n = A.n
    ndiags = A.data.shape[0]
    nnz = n * ndiags  # stored elements (incl. structural zeros at edges)
    bytes_per_step = (ndiags * n + 2 * n) * itemsize  # data + x + y
    flops = 2 * nnz + 4 * n  # fma per element + shift/correction terms
    sol = hbm_bw / bytes_per_step * nnz
    rep = RooflineReport(
        nnz=nnz,
        bytes_per_step=bytes_per_step,
        flops_per_step=flops,
        arithmetic_intensity=flops / bytes_per_step,
        sol_nnz_per_s=sol,
    )
    if measured_nnz_per_s is not None:
        rep.measured_nnz_per_s = measured_nnz_per_s
        rep.fraction_of_peak = measured_nnz_per_s / sol
    return rep


def _best_time(fn, trials: int) -> float:
    """Fastest of ``trials`` fenced runs of ``fn`` (already compiled)."""
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


@partial(jax.jit, static_argnames=("s",))
def _chain(A: DiaMatrix, q: jax.Array, s: int, reps: jax.Array):
    from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_monomial

    def body(i, v):
        return matrix_powers_monomial(A, v, s)[:, s]

    return lax.fori_loop(0, reps, body, q)


def measure_powers_throughput(
    A: DiaMatrix, s: int = 8, reps: int = 10, trials: int = 3
) -> float:
    """Device nnz/s of ``reps`` chained monomial matrix-powers calls
    (``reps`` is traced, so one compile serves every count)."""
    q = jnp.asarray(np.random.default_rng(0).standard_normal(A.n), A.dtype)
    run = lambda: _chain(A, q, s, jnp.int32(reps))  # noqa: E731
    jax.block_until_ready(run())  # compile + warm up
    return A.n * A.data.shape[0] * s * reps / _best_time(run, trials)


@jax.jit
def _negate_chain(x: jax.Array, reps: jax.Array) -> jax.Array:
    return lax.fori_loop(0, reps, lambda i, v: -v, x)


def measure_copy_bandwidth(x: jax.Array, reps: int = 20, trials: int = 3) -> float:
    """Device bytes/s of a streaming read+write of ``x`` (a negation per
    step, ``reps`` traced so XLA cannot fold the chain) — the achievable
    memory bandwidth a memory-bound kernel is compared with."""
    run = lambda: _negate_chain(x, jnp.int32(reps))  # noqa: E731
    jax.block_until_ready(run())  # compile + warm up
    return 2 * x.size * x.dtype.itemsize * reps / _best_time(run, trials)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace for TensorBoard; wrap the region of interest."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@partial(jax.jit, static_argnames=("s",))
def _ca_chain(A: DiaMatrix, Q0: jax.Array, s: int, blocks: jax.Array):
    """``blocks`` fully-fused CA iterations: matrix powers from the carry
    block's last column, two-pass CGS against the carry, CholQR2 — the
    device work of one outer iteration (no host syncs)."""
    from ca_lanczos_tpu.ops.matrix_powers import matrix_powers_monomial
    from ca_lanczos_tpu.ops.qr import cholqr2

    def body(i, Qp):
        V = matrix_powers_monomial(A, Qp[:, -1], s)
        X = V[:, 1:]
        for _ in range(2):
            X = X - mm(Qp, mm(Qp.T, X))
        Qn, _ = cholqr2(X)
        return jnp.concatenate([Qp[:, -1:], Qn], axis=1)

    return lax.fori_loop(0, blocks, body, Q0)


def measure_ca_iteration_throughput(
    A: DiaMatrix, s: int = 8, blocks: int = 10, trials: int = 3
) -> float:
    """CA-Lanczos iterations/second (one iteration = s SpMVs + block
    orth), fully fused on device — the 'iters/sec vs s' north-star
    metric (BASELINE.md)."""
    rng = np.random.default_rng(0)
    Q0 = jnp.asarray(
        np.linalg.qr(rng.standard_normal((A.n, s + 1)))[0].astype(A.dtype)
    )
    run = lambda: _ca_chain(A, Q0, s, jnp.int32(blocks))  # noqa: E731
    jax.block_until_ready(run())  # compile + warm up
    return blocks / _best_time(run, trials)
