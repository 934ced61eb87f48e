"""Communication cost model sweep (round-3 VERDICT item 7): per-device
collective volume of the distributed matrix-powers block and the CA
block step, swept over s x bandwidth x P on the virtual CPU mesh.

Volumes are read from the lowered jaxprs (the same walker as
tests/test_comm_model.py), so the table records what XLA actually
emits, not the design doc.  Writes results/comm_sweep.jsonl and prints
a markdown table for BENCHMARKS.md.

Model being verified: one halo exchange per s-step block =
2 * s_max * w * itemsize bytes/device, INDEPENDENT of s (the
communication-avoiding trade) and of P (ring exchange); block-orth
reductions O((s+1)^2), independent of n and P.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from ca_lanczos_tpu.ops.spmv import DiaMatrix
from ca_lanczos_tpu.parallel import make_mesh
from ca_lanczos_tpu.parallel.distributed import DistDia, dist_matrix_powers
from ca_lanczos_tpu.parallel.step import dist_ca_block
from tests.test_comm_model import collective_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "results", "comm_sweep.jsonl")


def banded(n, w, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-w, w + 1))
    data = (rng.standard_normal((len(offsets), n)) * 0.1).astype(dtype)
    return DiaMatrix(data=jnp.asarray(data), offsets=offsets)


def main():
    import jax as _j

    devs = _j.devices()
    rows = []
    for P in (2, 4, 8):
        mesh = make_mesh(P, devices=devs[:P])
        for w in (1, 2, 4):
            for s in (2, 4, 8):
                n = P * 2048
                A = DistDia.from_dia(banded(n, w), mesh, s_max=s)
                x = A.shard_vector(np.ones(n, np.float32), mesh)
                z = jnp.zeros(s, jnp.float32)
                vol, calls = collective_bytes(
                    lambda xx: dist_matrix_powers(A, xx, s, z, z, mesh), x
                )
                Q = A.shard_vector(
                    np.ones((n, s + 1), np.float32) / np.sqrt(n), mesh
                )
                vol_orth, _ = collective_bytes(
                    lambda QQ: dist_ca_block(A, QQ, z, z, s, mesh), Q,
                    names=("ppermute", "psum", "psum_invariant",
                           "all_gather", "all_reduce"),
                )
                expect = 2 * s * w * 4  # halo = s_max*w here, s_max = s
                rec = dict(
                    P=P, s=s, w=w, n=n,
                    halo_bytes_per_device=vol,
                    model_bytes=expect,
                    match=bool(vol == expect),
                    exchanges=len([c for c in calls if c[0] == "ppermute"]),
                    block_orth_collective_bytes=vol_orth,
                )
                rows.append(rec)
    # ---- Hierarchical (host x chip) meshes (round-5): same volumes,
    # partitioned by transport — intra-host ppermute pairs stay inside a
    # host, only the 2*(H-1) host-boundary pairs cross hosts, and the
    # psum tree reduces chip-level before host-level.
    from ca_lanczos_tpu.parallel import make_hier_mesh

    def ppermute_perms(fn, *args):
        jx = jax.make_jaxpr(fn)(*args)
        perms = []

        def walk(jaxpr):
            for eq in jaxpr.eqns:
                if eq.primitive.name == "ppermute":
                    shp = next(
                        tuple(v.aval.shape) for v in eq.invars
                        if hasattr(v.aval, "shape")
                    )
                    perms.append((eq.params["perm"], shp))
                for v in eq.params.values():
                    for sub in jax.tree_util.tree_leaves(
                        v, is_leaf=lambda t: hasattr(t, "eqns") or hasattr(t, "jaxpr")
                    ):
                        if hasattr(sub, "jaxpr"):
                            sub = sub.jaxpr
                        if hasattr(sub, "eqns"):
                            walk(sub)

        walk(jx.jaxpr)
        return perms

    s, w = 8, 4
    for H, C in ((2, 4), (4, 2)):
        mesh = make_hier_mesh(H, C, devices=devs[: H * C])
        n = H * C * 2048
        A = DistDia.from_dia(banded(n, w), mesh, s_max=s)
        x = A.shard_vector(np.ones(n, np.float32), mesh)
        z = jnp.zeros(s, jnp.float32)
        perms = ppermute_perms(
            lambda xx: dist_matrix_powers(A, xx, s, z, z, mesh), x
        )
        halo_b = 2 * s * w * 4
        dcn_pairs = sum(
            1 for perm, _ in perms for a, b in perm if a // C != b // C
        )
        ici_pairs = sum(
            1 for perm, _ in perms for a, b in perm if a // C == b // C
        )
        # per-pair bytes: each ppermute moves its operand per pair
        per_pair = int(np.prod(perms[0][1])) * 4
        rec = dict(
            table="hier_halo", H=H, C=C, s=s, w=w, n=n,
            halo_bytes_per_device=halo_b,
            dcn_pairs=dcn_pairs, ici_pairs=ici_pairs,
            dcn_bytes_per_boundary=per_pair,
            dcn_pairs_model=2 * (H - 1),
            match=bool(dcn_pairs == 2 * (H - 1)),
        )
        rows.append(rec)
        print(f"hier {H}x{C}: halo {halo_b} B/device, DCN pairs "
              f"{dcn_pairs} (model {2*(H-1)}), ICI pairs {ici_pairs}, "
              f"{per_pair} B per boundary")

    with open(OUT, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    ok = all(r["match"] for r in rows)
    print(f"all {len(rows)} cases match the 2*s*w*itemsize model: {ok}")
    # markdown table: volume vs s at w=4, P=8 (communication-avoiding
    # signature: bytes per block grow with s, bytes per SpMV SHRINK)
    print("\n| s | halo bytes/device/block | bytes per SpMV | orth collective bytes |")
    print("|---|---|---|---|")
    for r in rows:
        if r.get("P") == 8 and r["w"] == 4:
            print(f"| {r['s']} | {r['halo_bytes_per_device']} | "
                  f"{r['halo_bytes_per_device'] // r['s']} | "
                  f"{r['block_orth_collective_bytes']} |")
    print(f"\nwrote {OUT}")


if __name__ == "__main__":
    main()
