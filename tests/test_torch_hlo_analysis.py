"""The port's cost analysis (``repro_torch/launch/hlo_analysis.py``) on the
reference's five cases (``tests/launch/test_hlo_analysis.py``), with the
JAX package's ``analyze_hlo`` of the compiled HLO beside it where a
count is not exact by construction, and two cases of its own: a tensor
off the meta device raises, and a known allocation sequence gives its
exact peak.

Tolerances: the port's counts are exact (a Python loop runs and is
counted once an iteration); the JAX count of the scanned program is
held to the port's within 5%, the reference's own tolerance against
the unrolled formula.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.launch.hlo_analysis import (analyze_program,
                                             top_contributors,
                                             trace_program)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _jax_cost(f, *args):
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())


def test_loop_counts_every_iteration():
    def loop(x, w):
        h = x
        for i in range(12):
            h = torch.tanh(h @ w[i])
        return h

    c = analyze_program(loop, meta(256, 256), meta(12, 256, 256))
    expected = 12 * (2 * 256 ** 3 + 256 ** 2)
    assert c.flops == expected
    assert c.transcendentals == 12 * 256 ** 2

    def scanned(x, w):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, x, w)[0]

    cj = _jax_cost(scanned, jax.ShapeDtypeStruct((256, 256), jnp.float32),
                   jax.ShapeDtypeStruct((12, 256, 256), jnp.float32))
    assert abs(cj.flops - c.flops) / c.flops < 0.05


def test_dot_flops_with_contraction():
    c = analyze_program(lambda a, b: a @ b, meta(64, 512), meta(512, 128))
    assert c.flops == 2 * 64 * 512 * 128
    cj = _jax_cost(lambda a, b: a @ b,
                   jax.ShapeDtypeStruct((64, 512), jnp.float32),
                   jax.ShapeDtypeStruct((512, 128), jnp.float32))
    assert cj.flops == c.flops


def test_gather_counts_rows_not_table():
    table = meta(100_000, 64)                         # 25.6 MB
    idx = meta(32, dtype=torch.int64)
    c = analyze_program(lambda t, i: t[i] * 2.0, table, idx)
    assert c.bytes < 1e6
    # the rows read and written, the index, and the product's traffic
    assert c.bytes == 32 * 64 * 4 * 2 + 32 * 8 + 32 * 64 * 4 * 2
    c = analyze_program(lambda t, i: torch.index_select(t, 0, i), table, idx)
    assert c.bytes < 1e6


def test_scatter_counts_rows_written():
    def put(t, i, v):
        return t.index_add_(0, i, v)

    c = analyze_program(put, meta(100_000, 64), meta(32, dtype=torch.int64),
                        meta(32, 64))
    assert c.bytes < 1e6


def test_nested_loops_multiply():
    def nested(x):
        h = x
        for _ in range(3):
            g = h
            for _ in range(4):
                g = g @ g
            h = g
        return h

    c = analyze_program(nested, meta(128, 128))
    assert c.flops == 3 * 4 * 2 * 128 ** 3


def test_fused_lower_bound_below_total():
    c = analyze_program(lambda x: torch.tanh(x @ x) + 1.0, meta(512, 512))
    assert 0 < c.bytes_fused <= c.bytes
    # the product's operands and result only: tanh and + fuse away
    assert c.bytes_fused == 3 * 512 * 512 * 4


def test_tensor_off_meta_raises():
    with pytest.raises(ValueError, match="meta"):
        analyze_program(lambda a: a * 2, torch.ones(4))
    with pytest.raises(ValueError, match="meta"):
        analyze_program(lambda a: a + torch.ones(4), meta(4))
    model = torch.nn.Linear(4, 4)                     # CPU parameters
    with pytest.raises(ValueError, match="meta"):
        analyze_program(lambda m, x: m(x), model, meta(2, 4))


def test_known_allocations_give_their_peak():
    def prog(x):                  # x: 256 f32 = 1,024 B
        a = x * 2.0               # 1,024 live
        b = torch.cat([a, a])     # 3,072
        del a                     # 2,048
        c = torch.cat([b, b])     # 6,144
        s = c.sum()               # 6,148: the peak
        del b, c
        return s * 1.0            # 4 + 4

    cost, mem, out = trace_program(prog, meta(256))
    assert mem.temp_bytes == 2048 + 4096 + 4          # b, c and s
    assert mem.arg_bytes == 1024 and mem.out_bytes == 4
    assert out.shape == () and out.device.type == "meta"
    # views and in-place updates allocate nothing
    _, mem, _ = trace_program(lambda x: x.view(16, 16).t().mul_(2.0),
                              meta(256))
    assert mem.temp_bytes == 0


def test_top_contributors_name_the_module():
    lin = torch.nn.Linear(64, 32, device="meta")
    seq = torch.nn.Sequential(torch.nn.Linear(128, 64, device="meta"),
                              torch.nn.ReLU(), lin)

    def run(model, x):
        return model(x).sum()

    rows = top_contributors(run, seq, meta(8, 128), metric="flops", k=5)
    assert [(r[0], r[1], r[2]) for r in rows] == [
        (2.0 * 8 * 64 * 128, "0", "addmm"), (2.0 * 8 * 32 * 64, "2", "addmm")]
