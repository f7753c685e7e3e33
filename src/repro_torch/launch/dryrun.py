"""Dry-run: every (arch x shape x mesh) cell at full width and depth on the
meta device, its step run as DTensors on the mesh, each device's work its
own (port of ``repro/launch/dryrun.py``, which compiles the step for its
256 or 512 host devices and reads one device's partitioned program).

Per cell this driver:
  1. builds the params, the AdamW state, the batch (``train_batch_specs``)
     and the decode state (``init_decode_state``; its tokens from
     ``decode_specs``) on the meta device: shapes and dtypes, no memory;
  2. distributes every leaf as a DTensor on the mesh with the placements
     of ``parallel/sharding.py``'s specs — the counterpart of the
     reference's lower + compile: a spec that is no valid placement fails
     the cell — and sums each device's argument bytes from the local
     shards;
  3. runs the step once on those DTensors (their shards on the meta
     device) under ``sharding_ctx(mesh)`` and ``op_analysis.analyze``: one
     microbatch of a train step (distributed at its own size; its counts
     ``n_micro`` times), its gradient pinned to the moments' specs as the
     reference's accumulation pins it (a reduce-scatter over the data
     axes), then the AdamW update on the moments' shards, whose params go
     back to their own specs; a prefill, whose decode state is made at
     ``decode_state_specs``; a decode step, which writes its state in
     place.  The models pin the reference's layouts with ``constrain``
     (SP decode, the decode logits, Megatron sequence parallelism where
     ``seq_parallel``), and the kernels run on their shards by their
     sharding rules.  The flops, bytes and peak of the temporaries are
     rank 0's, which holds the largest shard where a dim splits unevenly:
     work that every device of a group repeats counts in full, an
     activation a device holds whole at its whole size;
  4. records the collectives that run issues, per device, in the
     reference's record (result bytes by kind, all-reduce 2x, call
     counts), and beside them those the specs imply
     (``launch/collectives.py``, ``collectives_derived``) and the ratio of
     the two totals; it also runs the step on the global tensors, whose
     counts over the device count are the even split that the record sets
     the per-device counts against (``work.whole``);
  5. computes the three roofline terms at the H100 SXM's dense peaks (989
     TFLOP/s bfloat16, 3.35 TB/s, 80 GB a device) and one 400 Gb/s NIC a
     device (50 GB/s; ``kernels/work.py``) from the per-device counts and
     the observed collectives, takes the largest as ``dominant``, and
     writes one JSON record per cell.

The mesh: the production meshes are CPU meshes over the fake process group
(``launch/mesh.py``) whose shards lie on the meta device.  DTensor's
sharding propagation needs a device module for its cost model, which a
meta-device mesh has not; on a CPU mesh DTensor stands an all-gather in
for an all-to-all (gloo has none), and the op counter counts that as the
all-to-all a card would run.  The host mesh is the card's, (n, 1) CUDA
(``make_host_mesh``), or (1, 1) on the CPU when asked for; on a (1, 1)
mesh every leaf is replicated and every count is the plain step's.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch granite-8b,xlstm-125m --shape train_4k,decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import (ARCHS, SHAPES, InputShape, ModelConfig, decode_specs,
                       shape_applicable, train_batch_specs)
from ..kernels import work
from ..models import init_decode_state, init_params
from ..optim import AdamWConfig, apply_updates, init_opt_state
from ..optim.adamw import leaves, tree_map
from ..parallel import (axis_sizes, batch_specs, constrain,
                        decode_state_specs, distribute, dp_axes,
                        opt_moment_specs, param_specs, sharding_ctx)
from ..parallel.sharding import is_distributed
from ..train import make_decode_step, make_grad_step, make_prefill_step
from .collectives import step_collectives
from .mesh import make_host_mesh, make_production_mesh
from .op_analysis import analyze

PEAK_FLOPS = work.H100_PEAK_FLOPS["bfloat16"]
HBM_BW = work.H100_BYTES_PER_S
HBM_PER_DEVICE = work.H100_HBM_BYTES
NET_BW = work.H100_NET_BYTES_PER_S

OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun_torch"

FSDP_BYTES_THRESHOLD = 2.5e9   # bf16 params per device above this -> FSDP


def n_micro_for(mesh) -> int:
    """Grad-accum microbatches per train step: keep one sequence per DP
    shard per microbatch (batch 256: 16 micro on single pod, 8 on multi)."""
    sizes = axis_sizes(mesh)
    dp = 1
    for a in dp_axes(mesh):
        dp *= sizes[a]
    return max(1, 256 // dp)


def make_accum_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                          n_micro: int, remat: bool = True,
                          grad_specs=None):
    """The reference's grad-accumulation train step, eager: the gradient of
    each of ``n_micro`` microbatches summed into a float32 buffer (the
    first microbatch's gradient itself where it is float32), divided by
    ``n_micro`` in place, then one AdamW update.  Returns ``(micro_grad,
    update)``: ``micro_grad(params, micro, gsum)`` gives the running sum
    (``gsum`` None for the first) and the loss; ``update(params, opt_state,
    gsum)`` gives (params, opt_state, info).  ``grad_specs`` (the moments'
    specs): under ``sharding_ctx`` each microbatch's sum is pinned there,
    as the reference pins it (ZeRO: a reduce-scatter of the gradient over
    the data axes a microbatch); plain tensors stay as they are."""
    grad_step = make_grad_step(cfg, remat=remat)

    def pin(tree):
        if grad_specs is None:
            return tree
        return tree_map(constrain, tree, grad_specs)

    def micro_grad(params, micro, gsum):
        grads, metrics = grad_step(params, micro)
        loss = metrics["total_loss"]
        if gsum is None:
            return pin(tree_map(lambda g: g.to(torch.float32), grads)), loss
        for acc, g in zip(leaves(gsum), leaves(pin(grads))):
            acc.add_(g)
        return gsum, loss

    def update(params, opt_state, gsum):
        if n_micro > 1:
            for g in leaves(gsum):
                g.div_(n_micro)
        return apply_updates(params, gsum, opt_state, opt_cfg)

    return micro_grad, update


@dataclasses.dataclass
class Cell:
    """One cell's abstract arguments, their specs and its kind."""
    cfg: ModelConfig
    kind: str
    args: dict          # name -> tree of meta tensors (the step's inputs)
    specs: dict         # name -> spec tree
    outs: dict          # name -> (tree, spec tree) of the step's outputs
    n_micro: int
    fsdp: bool


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def build_cell(cfg: ModelConfig, shape: InputShape, mesh, *,
               n_micro: int | None = None) -> Cell:
    """The cell's trees on the meta device.  TP shards params over
    "model"; where bf16 params per device still exceed the threshold (the
    70B VLM, the 30B MoEs) FSDP adds "data", and the config takes
    ``seq_parallel`` as the reference's launcher sets it."""
    per_dev_param_bytes = cfg.n_params * 2 / axis_sizes(mesh)["model"]
    use_fsdp = per_dev_param_bytes > FSDP_BYTES_THRESHOLD
    cfg = dataclasses.replace(cfg, seq_parallel=use_fsdp)
    params = init_params(cfg, device="meta")
    args = {"params": params}
    specs = {"params": param_specs(params, mesh, fsdp=use_fsdp)}
    outs = {}
    if shape.kind == "train":
        opt = init_opt_state(params)
        moments = opt_moment_specs(params, mesh)
        args["opt_state"] = opt
        specs["opt_state"] = {"m": moments, "v": moments, "step": ()}
        if "master" in opt:
            specs["opt_state"]["master"] = moments
        batch = train_batch_specs(cfg, shape)
        n_micro = n_micro or n_micro_for(mesh)
    elif shape.kind == "prefill":
        batch = train_batch_specs(cfg, shape)
        del batch["labels"]
        state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
        outs["state"] = (state, decode_state_specs(state, mesh))
    else:
        state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
        args["state"] = state
        specs["state"] = decode_state_specs(state, mesh)
        batch = decode_specs(cfg, shape)
    args["batch"] = batch
    specs["batch"] = batch_specs(batch, mesh)
    return Cell(cfg, shape.kind, args, specs, outs, n_micro or 1, use_fsdp)


def analyze_cell(cell: Cell, shape: InputShape, mesh=None) -> dict:
    """The step's work: ``op_analysis`` of one microbatch of a train step
    (its flops, bytes and collectives ``n_micro`` times) and of the update
    once; of the prefill or the decode step once.  ``peak_bytes``: the
    most the step holds beyond its arguments.  On ``mesh`` the step runs as
    DTensors at the cell's specs (a train step's microbatch distributed at
    its own size) under ``sharding_ctx``, and every count is one device's;
    without one, on the global tensors, every count is the whole step's."""
    cfg, a = cell.cfg, dict(cell.args)
    if cell.kind == "train":
        size = shape.global_batch // cell.n_micro
        a["batch"] = {k: v[:size] for k, v in a["batch"].items()}
    ctx = contextlib.nullcontext()
    if mesh is not None:
        specs = dict(cell.specs, batch=batch_specs(a["batch"], mesh))
        a = {name: distribute(tree, specs[name], mesh)
             for name, tree in a.items()}
        ctx = sharding_ctx(mesh)
    with ctx:
        if cell.kind == "train":
            micro_grad, update = make_accum_train_step(
                cfg, AdamWConfig(), n_micro=cell.n_micro,
                grad_specs=cell.specs["opt_state"]["m"])
            held = {}

            def one_micro():
                held["gsum"], _ = micro_grad(a["params"], a["batch"], None)

            g = analyze(one_micro)
            u = analyze(update, a["params"], a["opt_state"], held["gsum"])
            gsum_bytes = _local_bytes(held["gsum"])
            coll = _sum_records([(g["collectives"], cell.n_micro),
                                 (u["collectives"], 1)])
            return {"flops": cell.n_micro * g["flops"] + u["flops"],
                    "bytes": cell.n_micro * g["bytes"] + u["bytes"],
                    "peak_bytes": max(g["peak_bytes"],
                                      gsum_bytes + u["peak_bytes"]),
                    "collectives": coll, "micro": g, "update": u}
        with torch.no_grad():
            if cell.kind == "prefill":
                step = make_prefill_step(cfg, max_len=shape.seq_len)
                return analyze(step, a["params"], a["batch"])
            step = make_decode_step(cfg)
            return analyze(step, a["params"], a["state"],
                           a["batch"]["tokens"])


def _sum_records(parts) -> dict:
    """The collectives' records of ``(record, times)`` parts, summed."""
    out: dict = {"bytes": {}, "counts": {}, "entries": []}
    for rec, times in parts:
        for key in ("bytes", "counts"):
            for kind, v in rec[key].items():
                out[key][kind] = out[key].get(kind, 0) + times * v
        out["entries"] += [dict(e, count=e["count"] * times)
                           for e in rec["entries"]]
    out["bytes"].setdefault("total", 0)
    return out


def _name_axes(record: dict, mesh) -> dict:
    """The record with each entry's ``axis`` (a process group's name) named
    by the mesh dims whose group it is, this rank's."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    by_ranks = {tuple(dist.get_process_group_ranks(mesh.get_group(name))):
                name for name in mesh.mesh_dim_names}
    names: dict = {}
    for e in record["entries"]:
        g = e["axis"]
        if g not in names:
            ranks = tuple(dist.get_process_group_ranks(
                _resolve_process_group(g))) if g else ()
            names[g] = by_ranks.get(ranks, f"{len(ranks)} ranks")
        e["axis"] = names[g]
    return record


def count_collectives(cell: Cell, shape: InputShape, mesh) -> dict:
    """``collectives.step_collectives`` of the cell: a train step's
    ``n_micro`` microbatches and its update, or the prefill or decode step
    once."""
    cfg, a = cell.cfg, cell.args
    kw = {}
    if cell.kind == "train":
        batch = shape.global_batch // cell.n_micro
        kw["opt_specs"] = cell.specs["opt_state"]["m"]
    else:
        batch = shape.global_batch
    if cell.kind == "decode":
        seq, kw["decode_specs"] = 1, cell.specs["state"]
    else:
        seq = shape.seq_len
        if cell.kind == "prefill":
            kw["decode_specs"] = cell.outs["state"][1]
    return step_collectives(cfg, cell.kind, a["params"],
                            cell.specs["params"], mesh, batch=batch,
                            seq=seq, n_micro=cell.n_micro, **kw)


def _local_bytes(tree) -> int:
    """The bytes of a tree's local shards (its leaves' where they are plain
    tensors)."""
    return sum((t.to_local() if is_distributed(t) else t).numel()
               * t.element_size() for t in leaves(tree))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir,
             skip_existing: bool = False, *, cfg: ModelConfig | None = None,
             shape: InputShape | None = None, mesh=None,
             n_micro: int | None = None) -> dict:
    """One cell: ``ARCHS[arch]`` in bfloat16 at ``SHAPES[shape_name]`` on
    the ``mesh_kind`` mesh (single, multi, host), or the ``cfg``,
    ``shape`` and ``mesh`` given.  The step runs as DTensors on the mesh,
    its counts one device's; it also runs on the global tensors, whose
    counts over the device count are the even split that the record sets
    beside them (``work.whole``).  Writes and returns its record; a FAIL
    record keeps its traceback."""
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    path = Path(out_dir) / f"{tag}.json"
    if skip_existing and path.exists():
        return json.loads(path.read_text())
    cfg_full = ARCHS[arch] if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    ok, reason = shape_applicable(cfg_full, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        record.update(status="SKIPPED", reason=reason)
        _write(path, record)
        print(f"[dryrun] {tag}: SKIPPED ({reason.split(':')[0]})")
        return record
    t0 = time.perf_counter()
    try:
        if mesh is None:
            mesh = (make_host_mesh() if mesh_kind == "host" else
                    make_production_mesh(multi_pod=mesh_kind == "multi"))
        n_dev = mesh.size()
        base = (dataclasses.replace(cfg_full, dtype="bfloat16") if cfg is None
                else cfg_full)
        cell = build_cell(base, shape, mesh, n_micro=n_micro)
        dist = {name: distribute(tree, cell.specs[name], mesh)
                for name, tree in cell.args.items()}
        out_dist = {name: distribute(tree, spec, mesh)
                    for name, (tree, spec) in cell.outs.items()}
        args_local = {name: _local_bytes(t) for name, t in dist.items()}
        args_whole = {name: _nbytes(t) for name, t in cell.args.items()}
        outs_local = {name: _local_bytes(t) for name, t in out_dist.items()}
        del dist, out_dist
        t_build = time.perf_counter() - t0
        wk = analyze_cell(cell, shape, mesh)
        t_analyze = time.perf_counter() - t0 - t_build
        derived = count_collectives(cell, shape, mesh)
        coll = _name_axes(wk["collectives"], mesh)
        w = analyze_cell(cell, shape)
        even = {"flops": w["flops"], "bytes": w["bytes"],
                "peak_bytes": w["peak_bytes"],
                "per_device_over_even_split": {
                    k: wk[k] * n_dev / max(w[k], 1)
                    for k in ("flops", "bytes", "peak_bytes")}}

        flops_dev, bytes_dev = wk["flops"], wk["bytes"]
        compute_s = flops_dev / PEAK_FLOPS
        memory_s = bytes_dev / HBM_BW
        coll_s = coll["bytes"]["total"] / NET_BW
        dominant = max((("compute", compute_s), ("memory", memory_s),
                        ("collective", coll_s)), key=lambda kv: kv[1])[0]
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        model_flops = (6 if shape.kind == "train" else 2) * (
            cfg_full.n_active_params * tokens)
        args_b = sum(args_local.values())
        temp_b = wk["peak_bytes"]
        fits = args_b + temp_b <= HBM_PER_DEVICE
        record.update(
            status="OK", n_devices=n_dev,
            mesh_shape=axis_sizes(mesh), device="meta",
            mesh_device=mesh.device_type,
            build_s=t_build, analyze_s=t_analyze,
            n_micro=cell.n_micro, fsdp=cell.fsdp,
            params_counted=sum(t.numel() for t in leaves(cell.args["params"])),
            params_analytic=cfg_full.n_params,
            argument_bytes_per_device=args_local,
            argument_bytes_whole=args_whole,
            output_bytes_per_device=outs_local,
            memory={"argument_bytes_per_device": args_b,
                    "temp_bytes_per_device": temp_b,
                    "per_device_bytes": args_b + temp_b},
            fits_hbm=bool(fits),
            work={"flops": flops_dev, "bytes": bytes_dev,
                  "peak_bytes": temp_b,
                  "flops_per_device": flops_dev,
                  "bytes_per_device": bytes_dev,
                  "whole": even,
                  "parts": {k: v for k, v in wk.items()
                            if k not in ("flops", "bytes", "peak_bytes",
                                         "collectives")}},
            collectives=coll,
            collectives_derived=derived,
            collectives_observed_over_derived=(
                coll["bytes"]["total"] / derived["bytes"]["total"]
                if derived["bytes"]["total"] else None),
            roofline={
                "compute_s": compute_s, "memory_s": memory_s,
                "collective_s": coll_s, "dominant": dominant,
                "model_flops": float(model_flops),
                "flops_per_device": flops_dev,
                "useful_flops_ratio": float(model_flops / max(
                    flops_dev * n_dev, 1.0)),
                "peaks": {"flops": PEAK_FLOPS, "bytes_per_s": HBM_BW,
                          "hbm_bytes": HBM_PER_DEVICE,
                          "net_bytes_per_s": NET_BW,
                          "card": "H100 SXM data sheet, dense",
                          "net": "one 400 Gb/s NDR NIC a device"},
            },
        )
        print(f"[dryrun] {tag}: OK devices={n_dev} "
              f"per-dev={int((args_b + temp_b) / 2 ** 20)}MiB fits={fits} "
              f"compute={compute_s * 1e3:.1f}ms mem={memory_s * 1e3:.1f}ms "
              f"coll={coll_s * 1e3:.1f}ms dom={dominant} "
              f"(build {t_build:.1f}s analyze {t_analyze:.1f}s)", flush=True)
    except Exception as e:  # record failures — they are bugs to fix
        record.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}", flush=True)
    record["seconds"] = time.perf_counter() - t0
    _write(path, record)
    return record


def _write(path: Path, record: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1, default=str))


def sweep(archs, shapes, meshes, out_dir, skip_existing=False) -> list[dict]:
    """``run_cell`` over every (mesh, arch, shape); prints the counts."""
    t0 = time.perf_counter()
    results = [run_cell(arch, shape, mesh_kind, out_dir, skip_existing)
               for mesh_kind in meshes for arch in archs for shape in shapes]
    counts = {s: sum(r["status"] == s for r in results)
              for s in ("OK", "SKIPPED", "FAIL")}
    print(f"[dryrun] done: {counts['OK']} OK, {counts['SKIPPED']} skipped, "
          f"{counts['FAIL']} FAILED of {len(results)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = list(ARCHS) if args.arch is None else args.arch.split(",")
    shapes = list(SHAPES) if args.shape is None else args.shape.split(",")
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("pass --arch and --shape, or --all")
    results = sweep(archs, shapes, meshes, args.out, args.skip_existing)
    if any(r["status"] == "FAIL" for r in results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
