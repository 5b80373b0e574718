"""Dry run: trace every (arch × shape × mesh) cell on the meta device.

For each cell this shows, without running a kernel or allocating a
byte of device memory:
  * the program is coherent at full size: the model, the AdamW state,
    the batch and the decode state are built on **meta** (shapes and
    dtypes only, as ``jax.eval_shape`` builds the reference's), and the
    port's train step, prefill or decode step runs on them to its end;
  * what it costs: flops, bytes and the bytes a fusing backend cannot
    avoid (``launch/hlo_analysis.py``, one count an aten operation, every
    loop iteration counted), and the peak of its live intermediates
    beside the bytes of its arguments;
  * its roofline terms on one H100 SXM (``HARDWARE``).

On a mesh of one device (``make_host_mesh()``) a cell is the whole
program.  On a mesh of n > 1 (the production meshes, built on meta by
``make_production_mesh(device="meta")``) ``run_cell`` traces the
per-device program of the partitioned one, as the reference compiles
it, without a second card: it makes a default process group of the
"fake" backend of world n (this process is rank 0, and no collective
moves a byte) and a ``DeviceMesh`` of the mesh's shape and axis names;
every input is a ``DTensor`` whose shard is on meta, placed by
``param_sharding`` (the AdamW moments as their parameters) and
``state_sharding`` through ``spec_to_placements``, the batch over the
mesh's "pod" and "data" axes where they divide it (the reference's
``_batch_axes``); the program runs under ``implicit_replication`` (the
tensors it makes itself, positions and masks, join as replicated), and
its ``constrain`` calls redistribute.  The count is then rank 0's:
its local operations, collectives and storages
(``launch/hlo_analysis.py``).  The group is destroyed when the cell
ends; a cell refuses to run beside a default group it did not make.
A cell that raises is recorded by ``main`` as ``ok: false`` with the
error, as the reference records a cell that fails.

The training model holds f32 masters (``trainable=True``), as the port
trains; a serving model holds the compute dtype, as the port serves.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \
      --both-meshes
The cells run on the host mesh, the current CUDA card unless ``--device``
says otherwise (``--device cpu`` on a machine without one); the
production meshes of ``--multi-pod`` and ``--both-meshes`` are traced on
meta and need no card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch import nn

from ..configs import SHAPES, get_config, list_archs
from ..convert import port_param_specs
from ..distributed.sharding import POLICIES, active_mesh, logical_axes, \
    set_mesh, spec_to_placements, state_sharding, with_logical_rules
from ..models import Transformer, init_decode_state
from ..serve import make_prefill, make_serve_step
from ..train import AdamWConfig, adamw_init, make_train_step
from .hlo_analysis import host_ops_pass, top_contributors, trace_program
from .mesh import make_host_mesh, make_production_mesh

# H100 SXM hardware model (per card, at its 700 W power limit): dense
# bf16 tensor-core peak, HBM3 rate, NVLink rate per direction
HARDWARE = "NVIDIA H100 SXM, 700 W"
PEAK_FLOPS = 989e12      # bf16
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # bytes/s

# decode shapes that only make sense for sub-quadratic archs
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")

# per-(arch, shape) microbatch split for the train program, as the
# reference's dry run chose them
MICROBATCHES = {
    ("gemma2-27b", "train_4k"): 4,
    ("dbrx-132b", "train_4k"): 8,
    ("qwen2-moe-a2.7b", "train_4k"): 4,
    ("deepseek-7b", "train_4k"): 4,
    ("qwen1.5-4b", "train_4k"): 4,
    ("falcon-mamba-7b", "train_4k"): 8,
    ("seamless-m4t-medium", "train_4k"): 4,
    ("internvl2-1b", "train_4k"): 2,
    ("recurrentgemma-2b", "train_4k"): 2,
}

# the reference's per-arch sharding policy for the train shape (ZeRO-3
# with one micro-batch for the dense archs, DP×TP for the MoEs); serve
# shapes keep DP×TP.  --policy/--microbatches override; --baseline
# forces DP×TP.
TRAIN_POLICY = {
    "llama3.2-1b": ("zero3", 1),
    "qwen1.5-4b": ("zero3", 1),
    "gemma2-27b": ("zero3", 1),
    "deepseek-7b": ("zero3", 1),
    "internvl2-1b": ("zero3", 1),
    "recurrentgemma-2b": ("zero3", 1),
    "seamless-m4t-medium": ("zero3", 1),
    "falcon-mamba-7b": ("zero3", 1),
    "qwen2-moe-a2.7b": ("dp_tp", None),
    "dbrx-132b": ("dp_tp", None),
}


def _fake_process_group(n: int):
    """Make the process-wide default group of torch's "fake" backend,
    world ``n``, this process rank 0: collectives return at once, so a
    program over ``DTensor``s runs its per-rank part alone."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("a dry run over a mesh needs torch.distributed, "
                           "which this torch build lacks")
    if dist.is_initialized():
        raise RuntimeError("a dry run over a mesh makes its own fake default "
                           "process group, and one already exists in this "
                           "process: run it in a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "a dry run over a mesh needs torch's fake process-group backend, "
            "which importing torch.testing._internal.distributed.fake_pg "
            "registers; this torch has no such module") from e
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)


@contextlib.contextmanager
def device_mesh_of(mesh):
    """None on a mesh of one device; else, for the ``with`` block, a
    ``DeviceMesh`` of ``mesh``'s shape and axis names over a fake default
    process group of ``mesh.size`` ranks, destroyed on the way out."""
    if mesh.size == 1:
        yield None
        return
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    _fake_process_group(mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.devices.shape),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def place(t, device_mesh, spec):
    """A ``DTensor`` of ``t``'s global shape and dtype on
    ``device_mesh``, placed by ``spec``, whose shard (this rank's) is an
    empty meta tensor.  The spec must divide each dimension it shards."""
    from torch.distributed.tensor import DTensor, Shard
    placements = spec_to_placements(spec, device_mesh.mesh_dim_names)
    local = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = device_mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"{tuple(spec)} does not divide "
                                 f"{tuple(t.shape)} evenly")
            local[p.dim] //= n
    shard = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(shard, device_mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _batch_axes(mesh):
    """The mesh axes a batch is sharded over (the reference's)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def _batch_size(mesh):
    d = mesh.shape
    return d.get("pod", 1) * d.get("data", 1)


def _place_tree(tree, device_mesh, rule, path=()):
    """Each tensor leaf of nested dicts, lists and tuples placed by
    ``rule(path string, shape)``."""
    if isinstance(tree, torch.Tensor):
        p = "/".join(map(str, path))
        return place(tree, device_mesh, rule(p, tuple(tree.shape)))
    if isinstance(tree, dict):
        return {k: _place_tree(v, device_mesh, rule, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, device_mesh, rule, path + (i,))
                          for i, v in enumerate(tree))
    return tree


class _FsdpGathered(nn.Module):
    """A parametrization: the weight a layer reads is its parameter with
    the shards over the FSDP axes gathered (its other shards kept), as
    the JAX package's partitioner gathers an FSDP-sharded weight where a
    layer uses it; the redistribution's backward reduces the weight's
    gradient back to the parameter's placement."""

    def __init__(self, placements):
        super().__init__()
        self.placements = tuple(placements)

    def forward(self, w):
        return w.redistribute(w.device_mesh, self.placements)


def _place_model(model, cfg, device_mesh):
    """Swap every parameter of ``model`` for a ``DTensor`` placed by its
    JAX leaf's ``param_sharding`` spec (``convert.port_param_specs``);
    one sharded over the active rules' "fsdp" axes is read gathered over
    them (``_FsdpGathered``, registered under the parameter's name, so
    the model code reads it as before)."""
    from torch.distributed.tensor import Replicate
    from torch.nn.utils import parametrize
    specs = port_param_specs(cfg, model)
    fsdp = set(logical_axes("fsdp"))
    names = device_mesh.mesh_dim_names
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        placed = place(p.detach(), device_mesh, specs[name])
        setattr(module, leaf, nn.Parameter(placed,
                                           requires_grad=p.requires_grad))
        used = [Replicate() if names[i] in fsdp and q.is_shard() else q
                for i, q in enumerate(placed.placements)]
        if used != list(placed.placements):
            parametrize.register_parametrization(
                module, leaf, _FsdpGathered(used), unsafe=True)
    return model


def shape_specs(cfg, shape, mesh, device_mesh=None):
    """Meta stand-ins (no allocation) for every input of the program of
    ``shape`` (a ``ShapeConfig``): {"params", "opt", "batch"} for train,
    {"params", "batch"} for prefill, {"params", "state", "tokens"} for
    decode.  Token batches are int32, as the data pipeline gives them.
    On a mesh of more than one device each is a ``DTensor`` on
    ``device_mesh`` (``device_mesh_of``), placed as the reference places
    its inputs, under the active logical rules."""
    if mesh.size > 1 and device_mesh is None:
        raise ValueError("inputs over a mesh of more than one device need "
                         "its DeviceMesh (device_mesh_of)")
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def b_spec(shp, dtype=torch.int32):
        t = torch.empty(shp, dtype=dtype, device=meta)
        if device_mesh is None:
            return t
        ax = _batch_axes(mesh) if shp[0] % _batch_size(mesh) == 0 else None
        return place(t, device_mesh, (ax,) + (None,) * (len(shp) - 1))

    def model(**kw):
        m = Transformer(cfg, device=meta, **kw)
        return m if device_mesh is None else _place_model(m, cfg,
                                                          device_mesh)

    def text_batch():
        S_text = S - cfg.n_patches if cfg.family == "vlm" else S
        batch = {"tokens": b_spec((B, S_text))}
        if cfg.family == "vlm":
            batch["patches"] = b_spec((B, cfg.n_patches, cfg.patch_dim),
                                      torch.float32)
        if cfg.encoder_decoder:
            batch["frames"] = b_spec((B, S, cfg.patch_dim), torch.float32)
        return batch

    if shape.kind == "train":
        params = model(dtype=torch.float32, trainable=True)
        opt = adamw_init(dict(params.named_parameters()))
        batch = text_batch()
        batch["labels"] = b_spec(batch["tokens"].shape)
        return {"params": params, "opt": opt, "batch": batch}
    params = model()
    if shape.kind == "prefill":
        return {"params": params, "batch": text_batch()}
    # decode: one new token against a seq_len-deep cache
    state = init_decode_state(cfg, B, S,
                              src_len=S if cfg.encoder_decoder else 0,
                              device=meta)
    if device_mesh is not None:
        state = _place_tree(state, device_mesh, state_sharding)
    return {"params": params, "state": state, "tokens": b_spec((B, 1))}


def input_specs(arch: str, shape_name: str, mesh, cfg=None,
                device_mesh=None):
    """``shape_specs`` of the cell (arch × shape_name)."""
    return shape_specs(cfg or get_config(arch), SHAPES[shape_name], mesh,
                       device_mesh)


def build_program(arch: str, shape_name: str, cfg=None,
                  microbatches: int | None = None):
    """program(specs) → the cell's output: the port's train step, prefill
    or decode step on ``input_specs``'s inputs."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        mb = (microbatches if microbatches is not None
              else MICROBATCHES.get((arch, shape_name), 1))
        step = make_train_step(cfg, AdamWConfig(), microbatches=mb)
        return lambda specs: step(specs["params"], specs["opt"],
                                  specs["batch"])
    if shape.kind == "prefill":
        return lambda specs: make_prefill(specs["params"], shape.seq_len)(
            specs["batch"])
    return lambda specs: make_serve_step(specs["params"])(specs["tokens"],
                                                          specs["state"])


def _replicated(device_mesh):
    """``implicit_replication`` over a mesh (the plain tensors a program
    makes join its DTensors as replicated) and ``host_ops_pass``; nothing
    at one device."""
    if device_mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(host_ops_pass())
    return stack


def applicable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def run_cell(arch: str, shape_name: str, mesh, verbose=True,
             hlo_out: str | None = None, cfg=None, policy: str | None = None,
             microbatches: int | None = None) -> dict:
    """Trace one cell and return the reference's record of it
    (``lower_s`` the time to build the meta inputs and the program,
    ``compile_s`` the trace's; ``temp_bytes_per_dev`` the peak of live
    intermediates), per device on a mesh of more than one (see the
    module docstring).  ``hlo_out`` receives the trace's per-op rows by
    bytes (``top_contributors``), one JSON list a row."""
    cfg = cfg or get_config(arch)
    if policy is None:
        if SHAPES[shape_name].kind == "train":
            policy, mb_opt = TRAIN_POLICY.get(arch, ("dp_tp", None))
            if microbatches is None:
                microbatches = mb_opt
        else:
            policy = "dp_tp"

    t0 = time.perf_counter()
    old = active_mesh()
    set_mesh(mesh)
    try:
        with with_logical_rules(POLICIES[policy]), \
                device_mesh_of(mesh) as dm:
            specs = input_specs(arch, shape_name, mesh, cfg=cfg,
                                device_mesh=dm)
            program = build_program(arch, shape_name, cfg=cfg,
                                    microbatches=microbatches)
            t_lower = time.perf_counter() - t0
            with _replicated(dm):
                cost, mem, _ = trace_program(program, specs)
                t_compile = time.perf_counter() - t0 - t_lower
                if hlo_out:
                    rows = top_contributors(program, specs, k=10 ** 9)
                    with open(hlo_out, "w") as f:
                        for r in rows:
                            f.write(json.dumps(r) + "\n")
    finally:
        set_mesh(old)

    n_dev = mesh.size
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes / HBM_BW
    memory_fused_s = cost.bytes_fused / HBM_BW
    collective_s = cost.collective_bytes / LINK_BW
    shape = SHAPES[shape_name]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "n_devices": int(n_dev),
        "ok": True,
        "hardware": HARDWARE,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "temp_bytes_per_dev": int(mem.temp_bytes),
        "arg_bytes_per_dev": int(mem.arg_bytes),
        "out_bytes_per_dev": int(mem.out_bytes),
        "flops_per_dev": float(cost.flops),
        "product_flops_per_dev": float(cost.product_flops),
        "attention_flops_per_dev": float(cost.attention_flops),
        "bytes_per_dev": float(cost.bytes),
        "bytes_fused_per_dev": float(cost.bytes_fused),
        "collective_bytes_per_dev": float(cost.collective_bytes),
        "collective_counts": dict(cost.collective_counts),
        "collective_bytes_by_op": dict(cost.collective_bytes_by_op),
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_fused_s": memory_fused_s,
        "collective_s": collective_s,
        "bottleneck": max(
            [("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)], key=lambda kv: kv[1])[0],
        "model_flops_total": float(model_flops),
        "useful_flops_ratio": float(model_flops / (cost.flops * n_dev))
        if cost.flops else 0.0,
        "params": cfg.param_count(),
        "active_params": n_active,
    }
    if verbose:
        print(f"[{res['mesh']}] {arch} × {shape_name}: "
              f"trace {t_compile:.1f}s | "
              f"temp {mem.temp_bytes/2**30:.2f} GiB/dev | "
              f"args {mem.arg_bytes/2**30:.2f} GiB/dev | "
              f"compute {compute_s*1e3:.2f} ms, memory {memory_s*1e3:.2f} ms,"
              f" collective {collective_s*1e3:.2f} ms → {res['bottleneck']}"
              f" | useful {res['useful_flops_ratio']*100:.0f}% "
              f"({HARDWARE})")
    return res


def run_cells(cells, meshes, policy=None, microbatches=None, hlo_out=None):
    """``run_cell`` for each (arch, shape) on each (label, make_mesh) of
    ``meshes``; a cell that raises, or whose mesh cannot be built, is
    recorded as ``ok: false`` with the error."""
    results = []
    for label, make_mesh in meshes:
        try:
            mesh, err = make_mesh(), None
        except (ValueError, RuntimeError) as e:
            mesh, err = None, e
        for arch, shape in cells:
            try:
                if err is not None:
                    raise err
                results.append(run_cell(arch, shape, mesh, hlo_out=hlo_out,
                                        policy=policy,
                                        microbatches=microbatches))
            except Exception as e:  # noqa: BLE001
                print(f"FAIL [{label}] {arch} × {shape}: "
                      f"{type(e).__name__}: {e}")
                results.append({"arch": arch, "shape": shape,
                                "mesh": label, "ok": False,
                                "error": str(e)[:500]})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hlo-out", default=None)
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES))
    ap.add_argument("--baseline", action="store_true",
                    help="paper-faithful DP×TP everywhere (pre-hillclimb)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the host mesh's device (default: cuda)")
    args = ap.parse_args(argv)

    def production(multi_pod):
        return ("2x16x16" if multi_pod else "16x16",
                lambda: make_production_mesh(multi_pod=multi_pod,
                                             device="meta"))

    if args.both_meshes:
        meshes = [production(False), production(True)]
    elif args.multi_pod:
        meshes = [production(True)]
    else:
        meshes = [("1x1", lambda: make_host_mesh(args.device))]

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES
                 if applicable(arch, shape)]
    else:
        cells = [(args.arch, args.shape)]

    pol = "dp_tp" if args.baseline else args.policy
    results = run_cells(cells, meshes, policy=pol,
                        microbatches=args.microbatches, hlo_out=args.hlo_out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(r.get("ok") for r in results)
    print(f"{n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
