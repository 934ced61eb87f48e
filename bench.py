"""Kernel benchmark: nnz/s of the CA-Lanczos matrix-powers scan on one GPU.

The matrix-powers block [q, Aq, ..., A^s q] is the hot kernel of every
solve.  This measures the plain XLA scan (ops.matrix_powers) on a banded
f32 operator of 2^23 rows x 9 diagonals (302 MB of planes, well above the
card's 50 MB L2), s=8, chained inside one jit and fenced with
``block_until_ready``, next to a device copy of the same bytes measured in
the same process.  It refuses to run without a GPU.

Prints the card's ``nvidia-smi`` name and power limit, then ONE JSON line:
{"metric", "value", "unit", "device", "card", ...}.
"""

import json

import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.utils.cache import enable_compile_cache
from ca_lanczos_tpu.utils.device import card_info, require_gpu


def main():
    from ca_lanczos_tpu.ops.spmv import DiaMatrix
    from ca_lanczos_tpu.utils.profiling import (
        measure_copy_bandwidth, measure_powers_throughput, peak_hbm_bw,
        roofline_audit,
    )

    devices = require_gpu()
    enable_compile_cache()
    card = card_info()
    for line in card:
        print(line)

    # Banded operator scaled to spectral norm < 1 so chained powers stay
    # bounded without renormalization.
    n = 1 << 23
    offsets = tuple(range(-4, 5))
    rng = np.random.default_rng(0)
    data = np.asarray(rng.standard_normal((len(offsets), n)), np.float32) * 0.02
    data[len(offsets) // 2] += 0.8
    A = DiaMatrix(data=jnp.asarray(data), offsets=offsets)
    s = 8

    rates = sorted(
        measure_powers_throughput(A, s=s, reps=20, trials=3) for _ in range(5)
    )
    rate = rates[len(rates) // 2]  # median of 5
    kind = devices[0].device_kind
    rep = roofline_audit(A, rate, hbm_bw=peak_hbm_bw(kind))
    scan_bw = rate / rep.nnz * rep.bytes_per_step
    copy_bw = measure_copy_bandwidth(A.data)
    print(json.dumps({
        "metric": "matrix_powers_spmv_throughput",
        "value": rate / 1e9,
        "unit": "Gnnz/s",
        "spread_min": rates[0] / 1e9,
        "spread_max": rates[-1] / 1e9,
        "trials": len(rates),
        "path": "xla",
        "n": n, "ndiags": len(offsets), "s": s,
        "scan_gb_s": scan_bw / 1e9,
        "copy_gb_s": copy_bw / 1e9,
        "share_of_copy": scan_bw / copy_bw,
        "share_of_peak": rep.fraction_of_peak,
        "device": {"platform": devices[0].platform, "kind": kind,
                   "count": len(devices)},
        "card": card,
    }))


if __name__ == "__main__":
    main()
