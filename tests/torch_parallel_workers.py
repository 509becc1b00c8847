"""Rank bodies of the port's multi-rank CPU tests, and the spawner.

`spawn(world, body, payload, tmp)` starts `world` processes with
`torch.multiprocessing` (spawn), each joining a gloo group through a
`file://` store under `tmp` (no TCP port, so parallel test workers do
not collide), running `body(rank, world, payload)` with one torch
thread, and returns each rank's result (pickled through `tmp`). A
spawned process re-imports this module, so it imports torch, numpy and
the port only, never JAX: the tests compute JAX's values in their own
process and pass inputs in as numpy.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch

from news_image_caption_tpu_torch.parallel import distributed as pdist
from news_image_caption_tpu_torch.parallel.mesh import MeshConfig, make_mesh


def _entry(rank, world, init, body, payload, tmp, join):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        if join:
            pdist.initialize(init, world, rank, device="cpu")
        result = globals()[body](rank, world, payload)
    except BaseException:
        result = {"error": traceback.format_exc()}
    finally:
        pdist.shutdown()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(world: int, body: str, payload, tmp, join: bool = True) -> list:
    """Each rank's `body(rank, world, payload)`. join: whether the rank
    joins the group before the body (a body that runs the train command
    joins through its `trainer.distributed` block)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    init = f"file://{tmp / 'store'}"
    torch.multiprocessing.spawn(_entry, nprocs=world, join=True, args=(
        world, init, body, payload, str(tmp), join))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    errors = [(r, res["error"]) for r, res in enumerate(out)
              if isinstance(res, dict) and "error" in res]
    if errors:
        # A rank that failed first, not a peer that lost it.
        r, err = min(errors, key=lambda e: "closed by peer" in e[1])
        raise RuntimeError(f"rank {r}:\n{err}")
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# -- the mesh ----------------------------------------------------------

def mesh_checks(rank, world, payload):
    """Each mesh config's (axis names, shape, this rank's coordinate),
    the error of a config that does not cover the world, this rank's
    rows under `place_local`, `global_sums` of per-rank values, and
    `any_rank` of a flag set on the last rank and of one set on none."""
    from news_image_caption_tpu_torch.parallel.collectives import (
        data_parallel, global_sums)
    from news_image_caption_tpu_torch.parallel.distributed import (
        local_rows, place_local)
    out = {"meshes": []}
    for cfg in payload["configs"]:
        mesh = make_mesh(MeshConfig(**cfg), "cpu")
        out["meshes"].append((list(mesh.mesh_dim_names),
                              list(mesh.mesh.shape),
                              list(mesh.get_coordinate())))
    out["bad"] = _error(lambda: make_mesh(MeshConfig(**payload["bad"]),
                                          "cpu"))
    mesh = make_mesh(MeshConfig(data=world), "cpu")
    batch = payload["batch"]
    placed = place_local(batch, mesh, "cpu")
    out["rows"] = {k: _np(v) for k, v in placed.items()}
    out["uneven"] = _error(lambda: local_rows(mesh, world + 1))
    x = torch.tensor([float(rank + 1), 2.0 * rank], requires_grad=True)
    n = torch.tensor(rank + 3)
    with data_parallel(mesh, 1):
        xs, ns = global_sums(x, n)
    (xs * torch.tensor([1.0, 3.0])).sum().backward()
    out["sums"] = (_np(xs), int(ns), _np(x.grad))
    flags = torch.distributed.new_group(backend="gloo")
    out["any"] = (pdist.any_rank(rank == world - 1, flags),
                  pdist.any_rank(False, flags))
    return out


# -- ring attention and the pipeline ------------------------------------

def _ring_case(mesh, case):
    from news_image_caption_tpu_torch.parallel.distributed import local_rows
    from news_image_caption_tpu_torch.parallel.ring import ring_attention
    from news_image_caption_tpu_torch.parallel.sequence import \
        shard_article_axis
    rows = local_rows(mesh, case["q"].shape[0])

    def local(a, grad=False):
        t = shard_article_axis(torch.from_numpy(a[rows]), mesh)
        return t.clone().requires_grad_(grad)

    q, k, v = (local(case[n], True) for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, local(case["mask"]), mesh)
    (out * local(case["w"])).sum().backward()
    return {"out": _np(out), "grads": [_np(t.grad) for t in (q, k, v)]}


def _layer_stage_fn(lp, carry):
    x = torch.tanh(carry["x"] @ lp["w"] + lp["b"])
    x = torch.where(carry["mask"][..., None], x, 0.0)
    return {"x": x, "mask": carry["mask"]}


def _pipe_case(mesh, case):
    from news_image_caption_tpu_torch.parallel.distributed import local_rows
    from news_image_caption_tpu_torch.parallel.pipe import (pipeline_apply,
                                                            stack_layers)
    layers = [{k: torch.from_numpy(v).requires_grad_(True)
               for k, v in lp.items()} for lp in case["layers"]]
    rows = local_rows(mesh, case["x"].shape[0])
    x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
    carry = {"x": x, "mask": torch.from_numpy(case["mask"][rows])}
    out = pipeline_apply(_layer_stage_fn, stack_layers(layers, mesh), carry,
                         mesh=mesh, n_micro=case["n_micro"])
    (out["x"] * torch.from_numpy(case["w"][rows])).sum().backward()
    return {"out": _np(out["x"]), "mask": _np(out["mask"]),
            "x_grad": (np.zeros_like(case["x"][rows]) if x.grad is None
                       else _np(x.grad)),
            "layer_grads": [None if lp["w"].grad is None else
                            {k: _np(t.grad) for k, t in lp.items()}
                            for lp in layers]}


def _encoder(payload, **kw):
    from news_image_caption_tpu_torch.models.roberta import RobertaEncoder
    enc = RobertaEncoder(**payload["roberta_kw"], **kw, device="cpu",
                         dtype=torch.float32)
    enc.load_state_dict({k: torch.from_numpy(v)
                         for k, v in payload["roberta_state"].items()})
    return enc


def _pipeline_model(payload, roberta):
    from news_image_caption_tpu_torch.models.pipeline import Gen3Pipeline
    model = Gen3Pipeline(resnet=payload["resnet_kw"], roberta=roberta,
                         device="cpu", dtype=torch.float32,
                         **payload["decoder_kw"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in payload["pipeline_state"].items()})
    return model


def ring_pipe(rank, world, payload):
    """Every case of `payload` on this rank: ring attention, pipeline
    outputs and gradients, the raises, the ring and pipelined RoBERTa
    encoders and both Gen3Pipeline YAML forms, alone and under the
    eval step of a data-parallel mesh (`row_meshes`)."""
    from news_image_caption_tpu_torch.parallel.distributed import local_rows
    from news_image_caption_tpu_torch.parallel.pipe import (pipeline_apply,
                                                            stack_layers)
    from news_image_caption_tpu_torch.parallel.ring import ring_attention
    from news_image_caption_tpu_torch.parallel.sequence import \
        shard_article_axis
    from news_image_caption_tpu_torch.training.train_step import \
        make_eval_step
    out = {"ring": [], "pipe": [], "errors": {}}
    for cfg, case in payload.get("ring", []):
        mesh = make_mesh(MeshConfig(**cfg), "cpu")
        out["ring"].append(_ring_case(mesh, case))
    for cfg, case in payload.get("pipe", []):
        mesh = make_mesh(MeshConfig(**cfg), "cpu")
        out["pipe"].append(_pipe_case(mesh, case))
    for name, cfg in payload.get("raises", {}).items():
        mesh = make_mesh(MeshConfig(**cfg), "cpu")
        t = torch.zeros(4, 8, 2, 2)
        keep = torch.ones(4, 8, dtype=torch.bool)
        lay = [{"w": torch.zeros(2, 2), "b": torch.zeros(2)}] * 4
        carry = {"x": torch.zeros(4 // max(1, world // 2), 3, 2),
                 "mask": torch.ones(4 // max(1, world // 2), 3,
                                    dtype=torch.bool)}
        fn = {"ring_no_axis": lambda: ring_attention(t, t, t, keep, mesh),
              "ring_indivisible": lambda: shard_article_axis(
                  torch.zeros(2, 7, 2), mesh),
              "pipe_no_axis": lambda: pipeline_apply(
                  _layer_stage_fn, stack_layers(lay), carry, mesh=mesh,
                  n_micro=2),
              "pipe_layers": lambda: stack_layers(lay[:3], mesh),
              "pipe_batch": lambda: pipeline_apply(
                  _layer_stage_fn, stack_layers(lay, mesh), carry,
                  mesh=mesh, n_micro=3),
              "pipe_microbatch": lambda: pipeline_apply(
                  _layer_stage_fn, stack_layers(lay, mesh), carry,
                  mesh=mesh, n_micro=carry["x"].shape[0] * 2)}[name]
        out["errors"][name] = _error(fn)
    if "roberta_state" in payload:
        ids = payload["ids"]
        ring_cfg, pipe_cfg, n_micro = payload["encoders"]
        mesh = make_mesh(MeshConfig(**ring_cfg), "cpu")
        rows = local_rows(mesh, ids.shape[0])
        last, hiddens = _encoder(payload, ring_mesh=mesh)(
            torch.from_numpy(ids[rows]))
        out["ring_encoder"] = (_np(last), len(hiddens))
        mesh = make_mesh(MeshConfig(**pipe_cfg), "cpu")
        rows = local_rows(mesh, ids.shape[0])
        enc = _encoder(payload)
        out["pipe_encoder"] = [_np(enc.encode_pipelined(
            torch.from_numpy(ids[rows]), mesh, m)) for m in (n_micro, None)]
    if "pipeline_state" in payload:
        batch = payload["batch"]
        for form in ("ring", "pipe"):
            roberta = dict(payload["roberta_kw"])
            roberta[form] = dict(payload[form + "_yaml"])
            model = _pipeline_model(payload, roberta)
            mesh = model.roberta.ring_mesh if form == "ring" else \
                model.roberta_pipe[0]
            rows = local_rows(mesh, batch["article_ids"].shape[0])
            local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
            ctx = model.encode(local)
            loss, _ = model.loss_fn(local)
            out[form + "_yaml"] = (_np(ctx["article"]), float(loss))
            # The same rows under a data-parallel step's mesh: one whose
            # data axis splits the encoder's partners, one that keeps
            # them on a data coordinate.
            apart, along = (make_eval_step(model.loss_fn, torch.float32,
                                           mesh=make_mesh(MeshConfig(**cfg),
                                                          "cpu"))
                            for cfg in payload["row_meshes"][form])
            out[form + "_apart"] = _error(lambda: apart(local))
            out[form + "_along"] = float(along(local)["loss"])
    return out


# -- the train command on data ranks --------------------------------------

def train_commands(rank, world, payload):
    """The port's train command on this rank for each run of `payload`:
    (config, overrides, the init's state dict or None for the command's
    own, attributes of the model to zero)."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import build_model
    results = []
    for path, overrides, state, patch in payload["runs"]:
        over = json.loads(overrides)
        over["trainer"]["distributed"] = {
            "coordinator_address": payload["init"] + f"_{len(results)}",
            "num_processes": world, "process_id": rank}
        saved = cli.training_model
        if state is not None:
            def carried(cfg, device, seed, state=state):
                model = build_model(cfg, device, torch.float32)
                model.param_module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in state.items()})
                for name in patch:      # dropouts the YAML cannot set
                    owner, attr = name.rsplit(".", 1)
                    setattr(functools.reduce(getattr, owner.split("."),
                                             model), attr, 0.0)
                return model
            cli.training_model = carried
        try:
            assert cli.main(["train", path, "--platform", "cpu", "-o",
                             json.dumps(over)]) == 0
        finally:
            cli.training_model = saved
        results.append(rank)
    return results


# -- the sharded checkpoint store ----------------------------------------

def sharded_store(rank, world, payload):
    """Save payload's state into a sharded store on every rank, then
    load the store saved on one rank (payload["load_dir"])."""
    from news_image_caption_tpu_torch.training.checkpoint_sharded import \
        ShardedCheckpointStore
    state = {"step": payload["step"],
             "params": {k: torch.from_numpy(v)
                        for k, v in payload["params"].items()}}
    store = ShardedCheckpointStore(payload["save_dir"], keep=2)
    store.save(state, payload["step"], {"loss": 1.0}, blocking=False)
    store.save(state, payload["step"] + 1, {"loss": 2.0})
    target = {"step": 0, "params": {k: torch.zeros_like(v)
                                    for k, v in state["params"].items()}}
    loaded = ShardedCheckpointStore(payload["load_dir"]).load(target,
                                                              "best")
    return {"step": loaded["step"],
            "params": {k: _np(v) for k, v in loaded["params"].items()},
            "files": sorted(os.listdir(Path(payload["save_dir"]) /
                                       f"ckpt_{payload['step']}"))}


# -- tensor parallelism ---------------------------------------------------

def _counting(calls: dict):
    """torch.distributed's all_reduce and all_gather wrapped to count
    the calls on each process group (restored by the returned undo)."""
    import torch.distributed as dist
    saved = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "all_gather")}

    def wrap(name):
        def call(*args, **kw):
            group = kw.get("group")
            calls[name, id(group)] = calls.get((name, id(group)), 0) + 1
            return saved[name](*args, **kw)
        return call

    for name in saved:
        setattr(dist, name, wrap(name))
    return lambda: [setattr(dist, n, f) for n, f in saved.items()]


def _tp_model(payload, mesh):
    from news_image_caption_tpu_torch.models.captioner import \
        TransformerFlattened
    from news_image_caption_tpu_torch.parallel.partition import shard_params
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **payload["dims"])
    model.decoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                                   payload["state"].items()})
    model.decoder.eval()
    shard_params(model.decoder, mesh)
    return model


def _tp_case(payload, cfg):
    """Every decode and the loss of `payload`'s model split over the
    mesh `cfg` on this rank: its rows of the batch (by data coordinate),
    the replicated B=1 requests of the two engines."""
    from news_image_caption_tpu_torch.generation.continuous import (
        ContinuousBatcher, ContinuousBeamBatcher)
    from news_image_caption_tpu_torch.generation.generator import \
        GenerationConfig
    from news_image_caption_tpu_torch.parallel.collectives import \
        data_parallel
    from news_image_caption_tpu_torch.parallel.distributed import (
        local_rows, place_local)
    from news_image_caption_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                            axis_group)
    mesh = make_mesh(MeshConfig(**cfg), "cpu")
    model = _tp_model(payload, mesh)
    batch = payload["batch"]
    rows = local_rows(mesh, batch["caption_ids"].shape[0])
    local = place_local(batch, mesh, "cpu")
    ctx = {k: v for k, v in local.items() if k != "caption_ids"}
    out = {"rows": (rows.start, rows.stop),
           "fc1": tuple(model.decoder.layers[0].fc1.kernel.shape),
           "heads": model.decoder.layers[0].image_attn.local_heads(),
           "embed_2": tuple(model.decoder.embedder.adaptive.embed_2.shape)}
    calls: dict = {}
    undo = _counting(calls)
    try:
        with data_parallel(mesh, rows.stop - rows.start):
            loss, _ = model.loss_fn(local)
    finally:
        undo()
    model_group = id(axis_group(mesh, MODEL_AXIS))
    out["model_collectives"] = sum(n for (_, g), n in calls.items()
                                   if g == model_group)
    out["loss"] = float(loss.detach())
    greedy = GenerationConfig(max_len=10, sampling_topk=1)
    toks, lps = model.generate(ctx, greedy)
    out["greedy"] = (_np(toks), _np(lps))
    toks, scores = model.generate_beam(ctx, GenerationConfig(
        max_len=10, beam_size=3, sampling_topk=1))
    out["beam"] = (_np(toks), _np(scores))
    toks, lps, n = model.generate_speculative(local, greedy, spec_k=4)
    out["speculative"] = (_np(toks), _np(lps), int(n))
    toks, lps = model.generate(ctx, GenerationConfig(
        max_len=10, sampling_topk=1, quantize_kv=True, quantize_head=True))
    out["quantized"] = (_np(toks), _np(lps))
    reqs = [{k: torch.from_numpy(v) for k, v in r.items()}
            for r in payload["requests"]]
    eng = ContinuousBatcher.for_flattened(
        model, GenerationConfig(max_len=8, sampling_topk=1), n_slots=2,
        inner_steps=2)
    ids = [eng.submit(r) for r in reqs]
    got = eng.run()
    out["continuous"] = [got[i][0] for i in ids]
    reqs = [{k: torch.from_numpy(v) for k, v in r.items()}
            for r in payload["beam_requests"]]
    eng = ContinuousBeamBatcher(model, GenerationConfig(max_len=8,
                                                        beam_size=3),
                                n_slots=2, inner_steps=2)
    ids = [eng.submit(r) for r in reqs]
    got = eng.run()
    out["beam_engine"] = [(got[i][0], got[i][1]) for i in ids]
    return out


def tensor_parallel(rank, world, payload):
    """Each mesh of payload["meshes"]: `_tp_case`; then the train
    command for each run of payload["train"] (config, overrides, the
    init's state dict or None, more arguments) on the world's ranks, each
    joining through
    its `trainer.distributed` block (a `file://` store under
    payload["init"])."""
    from news_image_caption_tpu_torch import cli
    from news_image_caption_tpu_torch.config import build_model
    out = {"cases": [_tp_case(payload, cfg) for cfg in payload["meshes"]]}
    # Each command joins and leaves a group of its own.
    pdist.shutdown()
    for i, (path, overrides, state, extra) in enumerate(payload["train"]):
        over = json.loads(overrides)
        over["trainer"]["distributed"] = {
            "coordinator_address": payload["init"] + f"_{i}",
            "num_processes": world, "process_id": rank}
        overrides = json.dumps(over)
        saved = cli.training_model
        if state is not None:
            def carried(cfg, device, seed, state=state):
                model = build_model(cfg, device, torch.float32)
                model.param_module.load_state_dict(
                    {k: torch.from_numpy(v) for k, v in state.items()})
                return model
            cli.training_model = carried
        try:
            assert cli.main(["train", path, "--platform", "cpu", "-o",
                             overrides, *extra]) == 0
        finally:
            cli.training_model = saved
    return out
