"""J of one class instance in both packages, on the CPU, in float64.

    PYTHONPATH=src python tools/class_reference.py SEED C PER
    PYTHONPATH=src python tools/class_reference.py batch SEED K C HI

The first form plans ``sample_class_workloads(SEED, K=1, C=C, B=10, count_range=(PER,
PER))`` with the JAX package's ``plan_classes`` (compiled), runs its
SmartFill recursion op by op (``jax.disable_jit()``) at the compiled
plan's order, plans the same instance with the port's ``plan_classes``
and prices both orders with the numpy oracle (``plan_classes_reference``).
For each run it prints J, J_linear and the largest CDR violation of a
Θ column, max over k of the spread of s_i'(θ_i)/c_i over the jobs that
column runs: a final CAP solve that did not converge shows there.  Last
the largest relative differences of the completion times T between the
reference's two runs and between the port and the compiled run.  The
constants of ``chip_smoke.py``'s phase 13 and the reference caveats in
``ROADMAP.md`` come from this script.  The op-by-op run takes about a
minute at C = 8 and four at C = 32.

The second form plans ``sample_class_workloads(SEED, K=K, C=C, B=10,
count_range=(0, HI))`` with ``plan_classes_batched`` in the JAX package
(compiled and op by op, ~9 minutes at K = 64, C = 16) and in the port,
and prints the largest relative differences of J (on the orders the
compiled run realizes, J == J_linear, and on the others) and J_linear
between each pair.
"""
import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402

JS = sys.modules["repro.core.smartfill"]
B = 10.0
KNOBS = dict(coarse=64, descent_iters=96, cap_iters=64)


def cdr_spread(A, w, g, s, theta, c):
    """max over columns k ≥ 1 of the relative spread of s_i'(θ_i)/c_i
    over the jobs i < k with θ_i > 1e-9·B in column k."""
    worst = 0.0
    for k in range(1, theta.shape[0]):
        th = theta[:k, k]
        on = th > 1e-9 * B
        if on.sum() < 2:
            continue
        r = (A[:k] * (w[:k] + s[:k] * th) ** g[:k] / c[:k])[on]
        worst = max(worst, float((r.max() - r.min()) / r.max()))
    return worst


def main(seed, C, per):
    out = {"seed": seed, "C": C, "per_class": per}
    st = J.sample_class_workloads(seed, K=1, C=C, B=B,
                                  count_range=(per, per)).state(0)
    t0 = time.perf_counter()
    plan = J.plan_classes(st)
    out["jax_compiled"] = {"J": plan.J, "J_linear": plan.J_linear,
                           "order": plan.order.tolist(),
                           "s": time.perf_counter() - t0}
    o = plan.order
    sp = J.class_speedup(st.sp, st.counts)
    per_class = [np.broadcast_to(np.asarray(getattr(sp, f), np.float64),
                                 (C,)) for f in ("A", "w", "gamma", "sigma")]
    leaves = [v[o] for v in per_class]
    spo = J.StackedSpeedup(*(jnp.asarray(v) for v in leaves), B=B)
    X, W = (st.counts * st.sizes)[o], (st.counts * st.weights)[o]

    def recursion():
        return JS._solve(spo, jnp.asarray(X), jnp.asarray(W), B, C,
                         *KNOBS.values(), False, stol_rel=1e-10)

    compiled = recursion()
    t0 = time.perf_counter()
    with jax.disable_jit():
        eager = recursion()
    out["jax_op_by_op"] = {"J": float(eager[5]), "J_linear": float(eager[6]),
                           "s": time.perf_counter() - t0}
    for key, res in (("jax_compiled", compiled), ("jax_op_by_op", eager)):
        out[key]["cdr_spread"] = cdr_spread(
            *leaves, np.asarray(res[0]), np.asarray(res[1]))
    out["jax_oracle_at_its_order"] = J.plan_classes_reference(st, order=o).J

    stp = P.sample_class_workloads(seed, K=1, C=C, B=B,
                                   count_range=(per, per),
                                   device="cpu").state(0)
    t0 = time.perf_counter()
    pp = P.plan_classes(stp)
    sched = pp.sched
    po = pp.order
    pleaves = [v[po] for v in per_class]
    out["port"] = {"J": pp.J, "J_linear": pp.J_linear,
                   "order": po.tolist(), "s": time.perf_counter() - t0,
                   "cdr_spread": cdr_spread(*pleaves, sched.theta.numpy(),
                                            sched.c.numpy())}
    out["port_oracle_at_its_order"] = P.plan_classes_reference(
        stp, order=po).J
    ref = out["jax_compiled"]["J"]
    out["port_minus_compiled"] = (pp.J - ref) / ref
    out["port_minus_op_by_op"] = ((pp.J - out["jax_op_by_op"]["J"])
                                  / out["jax_op_by_op"]["J"])
    out["oracle_minus_port"] = (out["port_oracle_at_its_order"] - pp.J) / pp.J
    # completion times, max relative difference over the classes
    T_c, T_e = np.asarray(compiled[4]), np.asarray(eager[4])
    out["T_op_by_op_vs_compiled"] = float(np.max(np.abs(T_e - T_c) / T_c))
    out["T_port_vs_compiled"] = float(np.max(np.abs(pp.T - plan.T)
                                             / plan.T))
    print(json.dumps(out, indent=1))


def batch(seed, K, C, hi):
    wl = J.sample_class_workloads(seed, K=K, C=C, B=B, count_range=(0, hi))
    args = (wl.counts, wl.sizes, wl.weights, wl.sp)
    runs = {"jax_compiled": J.plan_classes_batched(*args, B=B)}
    with jax.disable_jit():
        runs["jax_op_by_op"] = J.plan_classes_batched(*args, B=B)
    wp = P.sample_class_workloads(seed, K=K, C=C, B=B, count_range=(0, hi),
                                  device="cpu")
    runs["port"] = P.plan_classes_batched(wp.counts, wp.sizes, wp.weights,
                                          wp.sp, B=B)
    Jv = {k: np.asarray(v[1].J, np.float64) for k, v in runs.items()}
    Lv = {k: np.asarray(v[1].J_linear, np.float64) for k, v in runs.items()}
    ref_J, ref_L = Jv["jax_compiled"], Lv["jax_compiled"]
    realized = np.abs(ref_J - ref_L) / ref_J <= 1e-9
    out = {"seed": seed, "K": K, "C": C, "count_hi": hi,
           "realized": int(realized.sum())}
    for a, b in (("jax_op_by_op", "jax_compiled"), ("port", "jax_compiled"),
                 ("port", "jax_op_by_op")):
        dJ = np.abs(Jv[a] - Jv[b]) / Jv[b]
        dL = np.abs(Lv[a] - Lv[b]) / Lv[b]
        far = dJ > 1e-2
        out[f"{a}_vs_{b}"] = {
            "same_orders": bool(np.array_equal(np.asarray(runs[a][0]),
                                               np.asarray(runs[b][0]))),
            "J_realized": float(dJ[realized].max()),
            "J_unrealized": float(dJ[~realized].max()),
            "J_linear": float(dL.max()),
            "instances_over_1e-2": np.flatnonzero(far).tolist(),
            # the same without those instances
            "J_unrealized_others": float(dJ[~realized & ~far].max()),
            "J_linear_others": float(dL[~far].max())}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    if sys.argv[1] == "batch":
        batch(*(int(a) for a in sys.argv[2:6]))
    else:
        main(*(int(a) for a in sys.argv[1:4]))
