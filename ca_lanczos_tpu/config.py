"""Configuration enums and dataclasses for the CA-Lanczos framework.

The reference passes positional string args with per-driver validation and
hard-coded constants (reference: restarted_ca_lanczos.m:13-39, lanczos.m:20-32,
projectAndNormalize.m:10, normalize.m:9).  Here every knob is an explicit,
typed field in one config object.
"""

from __future__ import annotations

import dataclasses
import enum


class Basis(str, enum.Enum):
    """Krylov basis for the matrix-powers kernel (reference: ca_lanczos.m:61-72)."""

    MONOMIAL = "monomial"
    NEWTON = "newton"


class Orth(str, enum.Enum):
    """(Re)orthogonalization strategy (reference: lanczos.m:26-31)."""

    LOCAL = "local"
    FULL = "full"
    PERIODIC = "periodic"
    SELECTIVE = "selective"


class LejaVariant(str, enum.Enum):
    """Which Leja ordering to use.

    The reference's ``leja.m:23-31`` dispatcher ignores the *value* of its
    second argument: any second arg routes to ``real_leja`` (so
    ``leja(x,'nonmodified')`` at ca_lanczos.m:70 actually runs the
    real/modified path) and the single-arg form runs ``nonmodified_leja``.
    We make the choice explicit; drivers default to the variant the
    reference *actually executed* on their code path.
    """

    NONMODIFIED = "nonmodified"  # plain greedy Leja (nonmodified_leja.m)
    MODIFIED = "modified"  # conjugate-pair-atomic greedy (modified_leja.m)
    REAL = "real"  # uniquify+sort then modified (real_leja.m)
    COMPLEX = "complex"  # simple complex Leja (complex_leja.m)


class RestartStrategy(str, enum.Enum):
    """Restart-vector choice (reference: restarted_ca_lanczos.m:204-248)."""

    LARGEST = "largest"
    SMALLEST = "smallest"
    CLOSEST_CONV = "closest_conv"
    RANDOM = "random"


class QrMethod(str, enum.Enum):
    """Normalizer backend for the tall-skinny QR.

    TSQR (Householder via XLA) is the parity default; CHOLQR2 (two
    Cholesky-QR passes, pure Gram matmuls) is the throughput choice —
    Householder QR is a sequence of panel updates, while CholQR2 is two
    GEMMs + a replicated small Cholesky with equivalent orthogonality
    for well-conditioned blocks.
    """

    TSQR = "tsqr"
    CHOLQR2 = "cholqr2"


@dataclasses.dataclass(frozen=True)
class OrthParams:
    """Block-orthogonalization tolerances.

    reorth_tol: column-norm drop ratio triggering the second block-CGS pass
        (reference: projectAndNormalize.m:10).
    rank_tol: relative singular-value cutoff of the rank-revealing
        normalize (reference: normalize.m:9).
    reference_second_pass: if True, `project` reproduces the reference's
        second-pass trigger at project.m:44-46, which fires when *no*
        column lost more than half its norm (the conventional BCGS2
        criterion inverted).  If False, the conventional criterion is used.
    qr_method: normalizer backend (see QrMethod).
    mixed_precision: promote the small reductions — Gram products,
        Cholesky/R factors, triangular solves — to float64 while the
        basis and SpMV stay in the storage dtype (f32/bf16).  The Gram
        psum is tiny, so this buys reference-grade eigenpairs at f32
        memory bandwidth (an answer to f32's ~1e-2 eigenvalue error on
        large operators).  Requires ``jax_enable_x64=True``
        (otherwise the f64 casts silently truncate back to f32).
    """

    reorth_tol: float = 0.5
    rank_tol: float = 1.0e-8
    reference_second_pass: bool = True
    qr_method: QrMethod = QrMethod.TSQR
    mixed_precision: bool = False


@dataclasses.dataclass(frozen=True)
class LanczosConfig:
    """One config object for all drivers.

    Defaults mirror the reference's flagship driver
    (restarted_ca_lanczos.m:13-39): 10 wanted eigenpairs, s=6, Newton
    basis, local orth, tol = 1e-8 * normest(A), at most 200 restarts.
    """

    s: int = 6
    basis: Basis = Basis.NEWTON
    orth: Orth = Orth.LOCAL
    n_wanted: int = 10
    max_basis: int = 60  # max Krylov vectors per restart cycle
    tol: float = 1.0e-8  # scaled by normest(A) inside restarted drivers
    max_restarts: int = 200
    restart_strategy: RestartStrategy = RestartStrategy.LARGEST
    leja_variant: LejaVariant = LejaVariant.REAL
    orth_params: OrthParams = OrthParams()
    seed: int = 0
    # Verify each candidate pair's TRUE residual (one SpMV) before locking.
    # The reference trusts the beta*|y(end)| estimate, which goes spuriously
    # tiny once the recurrence breaks down past in-cycle convergence —
    # invisible in f64, fatal in f32.  Disable to reproduce reference
    # behavior exactly.
    verify_locked: bool = True
