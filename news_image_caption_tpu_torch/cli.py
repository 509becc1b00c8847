"""Command line of the port: `train` a YAML config, `evaluate` it on a
split, `serve` captions, `preprocess` raw records into shards, `port` a
reference checkpoint.

Counterpart of `news_image_caption_tpu/cli.py` (`main`, `train_command`,
`evaluate_command`, `serve_command`, `port_command`, and `preprocess`,
which runs `data/materialize.py::main`).

`train` builds the config's model, optimizer (`trainer.optimizer`, the
model's frozen collections left out, wrapped by `accumulate_gradients`
for `trainer.accumulate_steps`) and
the state that `trainer.mixed_precision` names, then runs the `Trainer`
over the train split (shuffled with the epoch as seed) and validates on
the val split, both through `DeviceLoader`. Checkpoints, `meta.json`,
`metrics.jsonl` and TensorBoard scalars go to the serialization
directory (`-s`, else `trainer.serialization_dir`, else
`serialization/` beside the config); `-r` resumes from the latest
checkpoint. With no checkpoint the weights are random, drawn in fp32
from a `torch.Generator` seeded with `trainer.seed` (default 0).

`evaluate` captions every batch of the split greedily (or by top-k
sampling with `generation.sampling_topk > 1`, a generator seeded with 0
for each batch, as the reference samples each batch with PRNGKey(0); or
by exact speculative greedy with `generation.speculative_k >= 2`, drafts
copied from the batch's `article_ids` by `generation.ngram_n`-grams, for
a model that has `generate_speculative`: not the LSTM or the
pipeline), writes
`generations{suffix}.jsonl` (each record enriched with names, entities,
readability and TTR unless `--no-enrich`) and
`evaluate-metrics{suffix}.json` (BLEU-1..4, CIDEr, ROUGE-L) into the
serialization directory, prints the metrics as one JSON line and, with
`--dump-attention DIR`, writes each batch's attention maps over its
captions to `DIR/attn_{batch:05d}.npz` (`layer{i}_{context}`, one a
layer and attended context: image, article, faces, obj). The batch's
every context goes to the device, so the faces, objects, GloVe and
no-image variants evaluate as the flagship does, and so do the pointer,
LSTM and Gen-2 families and the online pipeline, which stages only the
raw uint8 image and the article's ids and encodes them on the device (a
model without `attention_maps` warns and
skips the dump, as the reference does). With a `checkpoints/`
directory there it evaluates the checkpoint `-m` names (`best` by default,
`latest`, a step, or `avg:N` for the mean of the newest N); `-m` without
that directory, or a checkpoint that is not there, raises. With neither
it warns and draws random weights from a generator seeded with 0.

`serve` starts the server (`serving/base.py::CaptionServer`: a frontend
for client jobs, `-n` worker processes and a sink that publishes the
results), prints its addresses as one JSON line and, with `--http-port`,
starts the HTTP proxy and prints its port as a second; it serves until
SIGTERM, then stops the proxy, the server and its workers and exits 0.
`--task flagship` serves the flagship captioner in bf16 (`--params` a
'/'-joined .npz of the reference's params, else random weights seeded
with 0); `--task toy` the reference's tiny model in fp32 (on the card
through the decode kernels' generic variants: head size 8). The reference's
switches: `--speculative-k`, `--continuous-slots` (with
`--inner-steps`, `--harvest-lag`, `--continuous-beam`),
`--sampling-topk` and `--sampling-temp` (see `serving/worker.py`).

    python -m news_image_caption_tpu_torch.cli train \\
        configs/tiny_test.yaml --platform cpu -s DIR
    python -m news_image_caption_tpu_torch.cli evaluate \\
        configs/tiny_test.yaml --platform cpu \\
        -o '{"trainer": {"serialization_dir": "DIR"}}'
    python -m news_image_caption_tpu_torch.cli serve --http-port 0

All three run on the card unless `--platform cpu` is given, and raise
where there is no card. On the card the model computes in bf16 (the kernels'
type), except that `train` at fp32 computes in fp32, a model with
`use_flash_train` then through the flash kernels' generic variants
(`ops/flash_attention.py::route_flash`, as for bf16 heads outside 16-128);
`evaluate` casts the checkpoint's params to bf16 and decodes
through the four decode kernels: the fast ones at the flagship's widths,
their generic variants at any other (`configs/tiny_test.yaml` and
`tiny_pointer.yaml`: embed 16, 4 heads). On the CPU `train` computes
in the precision's dtype and `evaluate` in the config's (float32 unless
set), through the kernels' plain versions. `evaluate` takes the int8 K/V route with
`generation.quantize_kv` (decode_cross_attention_int8 on the card), as
`serve --quantize-kv / --quantize-head` do. `train` reads
`trainer.profile_steps` and `trainer.profile_start` (default 2): steps
[profile_start, profile_start + profile_steps) are traced by
`torch.profiler` into `<serialization_dir>/profile`.

`train` runs on several ranks, one process a device
(`parallel/__init__.py`): `trainer.distributed` joins them (a
{coordinator_address "host:port" or "file:///path", num_processes,
process_id} block per process, or `true` under torchrun), then
`trainer.mesh` ({data: -1, model: 1}) makes the rank mesh before the
model is built, and the steps are data-parallel over its `data` axis
(each rank trains on its rows of every global batch; rank 0 writes the
logs) and tensor-parallel over its `model` axis: the model built on
every rank keeps the rank's slices of the parameters the reference's
partition rules split (`parallel/partition.py::shard_params`; a dim the
axis does not divide raises, as the flagship's 30265-row band does at
any `model` above 1, in both packages), and the single-file checkpoints
hold the whole tensors. Launch with

    torchrun --nproc-per-node N -m news_image_caption_tpu_torch.cli \
        train CONFIG -o '{"trainer": {"distributed": true,
                                      "mesh": {"data": -1}}}'

`trainer.checkpoint_format: sharded` keeps directory-per-step
checkpoints written by every rank (`training/checkpoint_sharded.py`);
`evaluate` reads them when the format says so or when it finds them, and
refuses a directory of the reference's orbax store (its way in is
`models/from_jax.py::state_from_jax`).

`preprocess IN.jsonl PREFIX [flags]` writes `PREFIX-{i:05d}.nics` shards
(and their `.schema`) of the records' caption and article ids, copy
masks, ResNet-152 patches and RoBERTa-large features, computed on the
card (or with `--platform cpu`); a `dataset: {type: nics_shards}` block
then trains and evaluates on them. `port CONFIG best.th [-s DIR]` maps a
Transform-and-Tell `best.th` onto the config's model and writes it as the
store's best checkpoint (`port_command`); it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.config import (build_dataset, build_model,
                                                 build_optimizer, load_config)
from news_image_caption_tpu_torch.data.loader import (DeviceLoader,
                                                      host_tensor)
from news_image_caption_tpu_torch.data.synthetic import (CONTEXT_KEYS,
                                                        loss_inputs)
from news_image_caption_tpu_torch.evaluation.enrich import enrich_record
from news_image_caption_tpu_torch.evaluation.metrics import (BleuScorer,
                                                             CiderScorer,
                                                             RougeScorer)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig
from news_image_caption_tpu_torch.parallel.distributed import (
    initialize, shard_iterator, shutdown)
from news_image_caption_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from news_image_caption_tpu_torch.parallel.partition import shard_params
from news_image_caption_tpu_torch.training.checkpoint import (CheckpointStore,
                                                              check_layout)
from news_image_caption_tpu_torch.training.optim import accumulate_gradients
from news_image_caption_tpu_torch.training.train_step import (
    create_o2_train_state, create_train_state)
from news_image_caption_tpu_torch.training.trainer import (PRECISIONS,
                                                           Trainer,
                                                           TrainerConfig)

INIT_SEED = 0   # evaluate's random init seed when there is no checkpoint


def main(argv: Optional[list] = None, *,
         timings: Optional[Dict[str, Any]] = None) -> int:
    """timings, if given, gets the command's host-clock spans
    (`evaluate`) or its epochs', steps' and checkpoints' times
    (`train`)."""
    p = argparse.ArgumentParser(
        prog="python -m news_image_caption_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    pt = sub.add_parser("train", help="train a model from a YAML config")
    pt.add_argument("param_path")
    pt.add_argument("-o", "--overrides", default=None,
                    help="JSON dict merged over the YAML config")
    pt.add_argument("-r", "--recover", action="store_true",
                    help="resume from the latest checkpoint")
    pt.add_argument("-s", "--serialization-dir", default=None)
    pt.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="cpu: the plain versions on the CPU; default: the "
                         "card")
    pe = sub.add_parser("evaluate", help="generate + score on a split")
    pe.add_argument("param_path")
    pe.add_argument("-o", "--overrides", default=None,
                    help="JSON dict merged over the YAML config")
    pe.add_argument("-m", "--model-path", default=None,
                    help="checkpoint to load: best (default), latest, a "
                         "step, or avg:N")
    pe.add_argument("-s", "--suffix", default="")
    pe.add_argument("--split", default="test")
    pe.add_argument("--no-enrich", action="store_true",
                    help="write bare generation/caption records")
    pe.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="cpu: the plain versions on the CPU; default: the "
                         "card")
    pe.add_argument("--dump-attention", default=None, metavar="DIR",
                    help="write per-batch attention maps (.npz) over the "
                         "generated captions to DIR")
    pp = sub.add_parser(
        "preprocess",
        help="materialize raw jsonl records into fixed-shape NICS shards "
             "(the offline frozen-encoder pass, data/materialize.py)")
    pp.add_argument("input_jsonl")
    pp.add_argument("out_prefix")
    # The remaining flags go to data/materialize.py as they are (their
    # one definition): --records-per-shard, --caption-len,
    # --article-len, --no-copy-masks, --mongo-*, --platform.
    pp.add_argument("materialize_flags", nargs=argparse.REMAINDER,
                    help="flags forwarded to data/materialize.py")
    po = sub.add_parser(
        "port",
        help="port a reference torch checkpoint (best.th) into the "
             "checkpoint store, ready for evaluate / serve "
             "(models/port_checkpoint.py: the family detected from the "
             "state dict's keys)")
    po.add_argument("param_path", help="YAML config of the target model")
    po.add_argument("checkpoint", help="torch state dict (best.th)")
    po.add_argument("-o", "--overrides", default=None)
    po.add_argument("-s", "--serialization-dir", default=None)
    po.add_argument("--no-strict", action="store_true",
                    help="tolerate unconsumed reference keys")
    ps = sub.add_parser("serve",
                        help="start the captioning server (+HTTP proxy)")
    ps.add_argument("--task", default="flagship", choices=("flagship", "toy"),
                    help="the flagship captioner, or the reference's tiny "
                         "random-weight model for smoke tests (fp32)")
    ps.add_argument("-n", "--n-workers", type=int, default=1)
    ps.add_argument("--http-port", type=int, default=None,
                    help="also start the HTTP proxy on this port (0 = pick "
                         "a free port)")
    ps.add_argument("--max-len", type=int, default=32)
    ps.add_argument("--batch-size", type=int, default=1,
                    help="request batch of the workers' warmup")
    ps.add_argument("--quantize-kv", action="store_true",
                    help="int8 context K/V, one scale a key and head "
                         "(flagship; captions may differ near ties)")
    ps.add_argument("--quantize-head", action="store_true",
                    help="int8 head word tables, one scale a row "
                         "(flagship; captions may differ near ties)")
    ps.add_argument("--speculative-k", type=int, default=0,
                    help=">= 2: exact speculative greedy decode for jobs "
                         "that carry article_ids (the greedy tokens; "
                         "generation/speculative.py)")
    ps.add_argument("--continuous-slots", type=int, default=0,
                    help="> 0: the workers serve from a pool of N decode "
                         "slots refilled mid-flight "
                         "(generation/continuous.py), so a long caption "
                         "never holds up the others; jobs are single "
                         "requests (B=1) and may carry max_len; composes "
                         "with --speculative-k")
    ps.add_argument("--inner-steps", type=int, default=8,
                    help="continuous mode: decode steps a dispatch "
                         "(finished slots are harvested and refilled "
                         "between dispatches)")
    ps.add_argument("--harvest-lag", type=int, default=1,
                    help="continuous mode: dispatches kept in flight "
                         "before waiting on the oldest's results (the "
                         "copy to the host overlaps the next dispatches; "
                         "deeper lag keeps finished slots frozen longer)")
    ps.add_argument("--continuous-beam", action="store_true",
                    help="continuous mode serves exact beam search "
                         "(beam_size 5) from the pool; results carry "
                         "[beam, L+1] tokens and scores")
    ps.add_argument("--sampling-topk", type=int, default=1,
                    help="> 1: top-k sampled captions from the slot pool; "
                         "a job's rng_seed seeds its slot's generator "
                         "(default: the request id). Requires "
                         "--continuous-slots; excludes --continuous-beam "
                         "and --speculative-k")
    ps.add_argument("--sampling-temp", type=float, default=1.0,
                    help="sampling temperature (with --sampling-topk)")
    ps.add_argument("--no-early-exit", action="store_true")
    ps.add_argument("--params", default=None,
                    help=".npz of the reference's params ('/'-joined flat "
                         "keys) for the task's model")
    ps.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                    help="cpu: the workers decode with the plain versions "
                         "on the CPU; default: the card")
    ps.add_argument("--exit-after-ready", action="store_true",
                    help=argparse.SUPPRESS)  # test hook
    args = p.parse_args(argv)
    try:
        if args.command == "train":
            return train_command(args, timings)
        if args.command == "serve":
            return serve_command(args)
        if args.command == "port":
            return port_command(args)
        if args.command == "preprocess":
            from news_image_caption_tpu_torch.data.materialize import \
                main as materialize_main
            return materialize_main([args.input_jsonl, args.out_prefix]
                                    + args.materialize_flags)
        return evaluate_command(args, timings)
    finally:
        # A process group the command joined or made (`trainer.
        # distributed`, a mesh's world of one) ends with it.
        shutdown()


def speculative_settings(cfg: Dict):
    """(speculative_k, ngram_n) of the `generation:` block: speculative
    greedy decode at speculative_k >= 2, its prompt-lookup key length
    ngram_n (default 2, at least 1)."""
    raw = cfg.get("generation", {})
    raw_n = raw.get("ngram_n", 2)
    ngram_n = 2 if raw_n is None else int(raw_n)
    if ngram_n < 1:
        raise ValueError(f"generation.ngram_n must be >= 1, got {ngram_n}")
    return int(raw.get("speculative_k", 0) or 0), ngram_n


def generation_config(cfg: Dict) -> GenerationConfig:
    """The `generation:` block with the reference's evaluate defaults
    (beam_size 5, unused by greedy decode; early exit on). It reads
    `quantize_kv` (int8 context K/V) and, as the reference's evaluate,
    not `quantize_head`."""
    raw = cfg.get("generation", {})
    return GenerationConfig(
        max_len=raw.get("max_len", 100),
        sampling_topk=raw.get("sampling_topk", 1),
        sampling_temp=raw.get("sampling_temp", 1.0),
        beam_size=raw.get("beam_size", 5),
        early_exit=raw.get("early_exit", True),
        quantize_kv=raw.get("quantize_kv", False))


def evaluation_model(cfg: Dict, device: torch.device):
    """The config's model with the command's random init: bf16 on the
    card, the config's dtype on the CPU."""
    generator = torch.Generator(device=device).manual_seed(INIT_SEED)
    model = build_model(cfg, device, _evaluate_dtype(device), generator)
    model.param_module.eval()
    return model


def training_model(cfg: Dict, device: torch.device, seed: int):
    """The config's model in fp32 with the train command's random init,
    drawn from a generator seeded with `seed`."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return build_model(cfg, device, torch.float32, generator)


def _evaluate_dtype(device: torch.device) -> Optional[torch.dtype]:
    return torch.bfloat16 if device.type == "cuda" else None


def _device(platform: Optional[str]) -> torch.device:
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --platform cpu to run the "
                           "plain versions on the CPU")
    return torch.device("cuda")


def _serialization_dir(cfg: Dict, param_path: str,
                       override: Optional[str] = None) -> str:
    return (override or cfg.get("trainer", {}).get("serialization_dir")
            or os.path.join(os.path.dirname(param_path) or ".",
                            "serialization"))


def _precision(cfg: Dict) -> str:
    precision = cfg.get("trainer", {}).get("mixed_precision") or "fp32"
    if precision not in PRECISIONS:
        raise ValueError(f"trainer.mixed_precision {precision!r}: the port "
                         "has fp32, bf16 and bf16_o2")
    return precision


def _optimizer(cfg: Dict, model):
    """The config's optimizer for `model` (its frozen collections left
    out), wrapped for `trainer.accumulate_steps`."""
    every = int(cfg.get("trainer", {}).get("accumulate_steps", 1))
    return accumulate_gradients(build_optimizer(cfg, model), every)


def train_state(cfg: Dict, model, tx, precision: str,
                device: torch.device, mesh=None):
    """(the model that computes, its TrainState) for `precision` from
    `model`, the config's model in fp32: fp32 trains `model` itself;
    bf16 keeps its fp32 parameters as the state's and computes in a bf16
    copy; bf16_o2 stores the bf16 copy's parameters, `model`'s values
    as the fp32 master. With a mesh the bf16 copy is split as `model`
    is."""
    if precision == "fp32":
        return model, create_train_state(model.param_module, tx)
    compute = build_model(cfg, device, torch.bfloat16)
    if mesh is not None:
        shard_params(compute.param_module, mesh)
    if precision == "bf16":
        return compute, create_train_state(model.param_module, tx,
                                           compute=compute.param_module)
    return compute, create_o2_train_state(compute.param_module, tx,
                                          master=model.param_module)


def _loss_batches(batches, model):
    """The keys the loss reads (the caption and the model's
    `context_keys` where it names them, else the captioner's and its
    `batch_keys`), so the loader moves nothing else."""
    keys = getattr(model, "context_keys", None)
    keep = getattr(model, "batch_keys", ())
    for b in batches:
        yield ({k: b[k] for k in ("caption_ids",) + keys} if keys
               else loss_inputs(b, keep))


def train_command(args, timings: Optional[Dict[str, Any]] = None) -> int:
    cfg = load_config(args.param_path, args.overrides)
    tcfg = cfg.get("trainer", {})
    mesh_cfg = tcfg.get("mesh")
    fmt = tcfg.get("checkpoint_format", "msgpack")
    if fmt not in ("msgpack", "sharded"):
        raise ValueError(f"unknown trainer.checkpoint_format {fmt!r}; use "
                         "'msgpack' (the port's single files) or 'sharded'")
    device = _device(args.platform)
    # Multi-process bootstrap (`trainer.distributed`: a {coordinator_
    # address, num_processes, process_id} block, or true for torchrun's
    # environment), then the mesh, before the model is built.
    dist_cfg = tcfg.get("distributed")
    if dist_cfg:
        initialize(**(dist_cfg if isinstance(dist_cfg, dict) else {}),
                   device=device)
    mesh = make_mesh(MeshConfig(**mesh_cfg), device.type) if mesh_cfg \
        else None
    precision = _precision(cfg)
    serialization_dir = _serialization_dir(cfg, args.param_path,
                                           args.serialization_dir)
    model = training_model(cfg, device, int(tcfg.get("seed", 0)))
    if mesh is not None:
        shard_params(model.param_module, mesh)
    tx = _optimizer(cfg, model)
    model, state = train_state(cfg, model, tx, precision, device, mesh)
    train_ds = build_dataset(cfg, "train")
    val_ds = build_dataset(cfg, "val")
    batch_size = cfg.get("iterator", {}).get("batch_size", 16)
    trainer = Trainer(model.loss_fn, tx, TrainerConfig(
        num_epochs=tcfg.get("num_epochs", 10),
        patience=tcfg.get("patience"),
        keep_checkpoints=tcfg.get("num_serialized_models_to_keep", 10),
        validation_metric=tcfg.get("validation_metric", "loss"),
        maximize_metric=tcfg.get("maximize_metric", False),
        serialization_dir=serialization_dir,
        skip_nan_batches=tcfg.get("skip_nan_batches", True),
        mixed_precision=precision,
        log_every=tcfg.get("log_every", 40),
        summary_interval=tcfg.get("summary_interval", 512),
        profile_start=tcfg.get("profile_start", 2),
        profile_steps=tcfg.get("profile_steps", 0),
        seed=tcfg.get("seed", 0),
        checkpoint_format=tcfg.get("checkpoint_format", "msgpack")),
        mesh=mesh)

    # Every rank draws the global batches; the loader places its rows.
    def train_batches(epoch):
        return DeviceLoader(_loss_batches(shard_iterator(
            train_ds.batches(batch_size, seed=epoch)), model), device, mesh)

    def val_batches(epoch):
        return DeviceLoader(_loss_batches(shard_iterator(
            val_ds.batches(batch_size, shuffle=False)), model), device, mesh)

    trainer.train(state, train_batches, val_batches, recover=args.recover)
    if timings is not None:
        timings.update(epochs=trainer.epoch_times,
                       step_s=trainer.step_seconds,
                       checkpoints=trainer.store.timings)
    return 0


def checkpoint_store(cfg: Dict, ckpt_dir: str) -> CheckpointStore:
    """The store of `ckpt_dir`: `trainer.checkpoint_format`'s, else the
    sharded one where the directory holds directory-per-step
    checkpoints (as the reference detects them)."""
    fmt = cfg.get("trainer", {}).get("checkpoint_format")
    if fmt is None:
        fmt = ("sharded" if any(
            e.startswith("ckpt_") and os.path.isdir(os.path.join(ckpt_dir, e))
            for e in os.listdir(ckpt_dir)) else "msgpack")
    if fmt == "sharded":
        from news_image_caption_tpu_torch.training.checkpoint_sharded import \
            ShardedCheckpointStore
        return ShardedCheckpointStore(ckpt_dir)
    return CheckpointStore(ckpt_dir)


def checkpoint_model(cfg: Dict, ckpt_dir: str, which: str,
                     device: torch.device):
    """The config's model holding the params of checkpoint `which`
    (best, latest, a step or avg:N, their fp64 mean), cast to the
    evaluate dtype. The params must have the model's names, shapes and
    the dtypes its training precision stores (bf16 for bf16_o2; else
    fp32, or the config's `param_dtype` where narrower), so a checkpoint
    of another model or precision raises."""
    stored = (torch.bfloat16 if _precision(cfg) == "bf16_o2"
              else torch.float32)
    layout = build_model(cfg, "meta", stored).param_module
    store = checkpoint_store(cfg, ckpt_dir)
    if which.startswith("avg:"):
        params = store.read_averaged(last_n=int(which[4:]), key="params")
    else:
        params = store.read(which, "params")
    model = build_model(cfg, device, _evaluate_dtype(device))
    module = model.param_module
    template = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for k, p in layout.named_parameters()}
    check_layout(template, params, "params")
    module.load_state_dict(params)
    module.eval()
    return model


def evaluate_command(args,
                     timings: Optional[Dict[str, float]] = None) -> int:
    cfg = load_config(args.param_path, args.overrides)
    device = _device(args.platform)
    gcfg = generation_config(cfg)
    spec_k, ngram_n = speculative_settings(cfg)
    out_dir = _serialization_dir(cfg, args.param_path)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    ds = build_dataset(cfg, args.split)
    if os.path.isdir(ckpt_dir):
        model = checkpoint_model(cfg, ckpt_dir, args.model_path or "best",
                                 device)
    elif args.model_path:
        raise FileNotFoundError(f"-m {args.model_path}: no checkpoints "
                                f"directory {ckpt_dir}")
    else:
        print(f"warning: no checkpoint in {ckpt_dir}; using random init "
              f"(torch.Generator seeded with {INIT_SEED})", file=sys.stderr)
        model = evaluation_model(cfg, device)
    metrics = evaluate(
        model, ds, gcfg, out_dir,
        batch_size=cfg.get("iterator", {}).get("batch_size", 16),
        suffix=args.suffix, enrich=not args.no_enrich,
        dump_attention=args.dump_attention, timings=timings,
        spec_k=(spec_k if gcfg.sampling_topk == 1
                and hasattr(model, "generate_speculative") else 0),
        ngram_n=ngram_n)
    print(json.dumps(metrics))
    return 0


def port_command(args) -> int:
    """best.th -> checkpoint store: the migration path of a
    Transform-and-Tell user (port a `best.th`, then `evaluate -m best` or
    `serve` against the same config). The reference's `port_command`:
    the family's flax tree from `port_checkpoint`, shaped by
    `assemble_for_init` and grafted by `merge_into_init` onto the
    config's model, here the port's model in fp32 on the CPU (random
    weights from `trainer.seed`, kept for what the checkpoint lacks) seen
    in flax naming (`from_jax.flax_view`), then loaded back strictly
    (`params_from_jax`) and saved as step 0 with the best metric, in the
    layout of the config's `mixed_precision`. The bundled frozen encoders
    go beside it as `{resnet,roberta}_ported.pt`, `torch.save` state
    dicts in the port's layout (`from_jax.encoder_state`). Only arrays
    are mapped: no card is needed."""
    from news_image_caption_tpu_torch.models.from_jax import (
        encoder_state, flax_view, params_from_jax)
    from news_image_caption_tpu_torch.models.port_checkpoint import (
        assemble_for_init, merge_into_init, port_checkpoint)
    cfg = load_config(args.param_path, args.overrides)
    device = torch.device("cpu")
    model = training_model(cfg, device,
                           int(cfg.get("trainer", {}).get("seed", 0)))
    init_params = flax_view(model.param_module)
    try:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
    except Exception:
        # Older pickled formats (AllenNLP-era best.th)
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()

    mcfg = dict(cfg.get("model", {}))
    dcfg = mcfg.get("decoder") or mcfg
    ported = port_checkpoint(
        sd,
        num_layers=int(dcfg.get("num_layers", 4)),
        embed_dim=int(dcfg.get("embed_dim", 1024)),
        n_bands=len(dcfg.get("cutoff", (5000, 20000, 50265))),
        strict=not args.no_strict)
    if ported["unused"]:
        print(f"warning: {len(ported['unused'])} reference keys "
              f"unconsumed: {ported['unused'][:5]}...", file=sys.stderr)
    print(f"detected family: {ported['model']} "
          f"(config model type: {mcfg.get('type')})")
    cand, warnings = assemble_for_init(ported, init_params)
    for w in warnings:
        print(w, file=sys.stderr)
    try:
        cand, dropped = merge_into_init(init_params, cand)
    except KeyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if dropped:
        print(f"note: dropped {len(dropped)} ported leaves the model "
              f"does not own (dead reference params): "
              f"{dropped[:4]}...", file=sys.stderr)
    model.param_module.load_state_dict(
        params_from_jax(cand, model.param_module))

    serialization_dir = _serialization_dir(cfg, args.param_path,
                                           args.serialization_dir)
    ckpt_dir = os.path.join(serialization_dir, "checkpoints")
    store = CheckpointStore(ckpt_dir)
    tx = _optimizer(cfg, model)
    _, state = train_state(cfg, model, tx, _precision(cfg), device)
    # The metric marks it best, so evaluate's default (-m best) and
    # serve pick the ported weights up.
    store.save(state, step=0, metrics={store.best_metric: 0.0})
    print(f"ported checkpoint written to {ckpt_dir} (best + step 0)")

    for enc in ("roberta", "resnet"):
        if enc in ported:
            path = os.path.join(ckpt_dir, f"{enc}_ported.pt")
            torch.save(encoder_state(ported[enc], enc), path)
            print(f"bundled frozen {enc} encoder written to {path} (a "
                  "state dict in the port's layout, for load_state_dict)")
    return 0


def serve_command(args) -> int:
    """Start the server with N captioning workers (and the HTTP proxy)
    and block until SIGTERM. Counterpart of the reference's
    `serve_command`: the same argument errors (exit 2), addresses and
    port printed as JSON lines, graceful SIGTERM."""
    import functools
    import signal

    from news_image_caption_tpu_torch.serving.base import CaptionServer
    from news_image_caption_tpu_torch.serving.worker import (
        CaptioningWorker, check_serving_args, default_model_builder,
        flagship_model_builder)
    from news_image_caption_tpu_torch.training.preemption import \
        PreemptionHandler

    if args.continuous_beam and args.continuous_slots <= 0:
        # Never silently serve greedy payloads to a client expecting
        # [beam, L+1] tokens + scores.
        print("error: --continuous-beam requires --continuous-slots N",
              file=sys.stderr)
        return 2
    if args.sampling_topk > 1:
        # Sampling is served from the slot pool only; a plain worker
        # would silently serve greedy captions instead.
        if args.continuous_slots <= 0:
            print("error: --sampling-topk requires "
                  "--continuous-slots N", file=sys.stderr)
            return 2
        if args.continuous_beam or args.speculative_k >= 2:
            print("error: --sampling-topk excludes --continuous-beam "
                  "and --speculative-k", file=sys.stderr)
            return 2
    # Everything that would make every worker fail raises here, before
    # a worker is spawned (the monitor would respawn it in a loop).
    check_serving_args(args.speculative_k, args.continuous_slots,
                       args.continuous_beam, args.sampling_topk)
    device = _device(args.platform)
    if device.type == "cuda":
        # Compile the kernels once here; the workers then load the
        # library instead of each running nvcc.
        from news_image_caption_tpu_torch.ops import _build
        _build.build()

    # Graceful SIGTERM (systemd/k8s stop, pod eviction): installed
    # BEFORE worker spawn so a stop during startup still reaches the
    # finally block, which drains the proxy and terminates the worker
    # processes instead of orphaning them.
    guard = PreemptionHandler((signal.SIGTERM,))
    guard.__enter__()

    switches = dict(speculative_k=args.speculative_k,
                    continuous_slots=args.continuous_slots,
                    inner_steps=args.inner_steps,
                    harvest_lag=args.harvest_lag,
                    continuous_beam=args.continuous_beam,
                    sampling_topk=args.sampling_topk,
                    sampling_temp=args.sampling_temp)
    if args.task == "toy":
        builder = functools.partial(default_model_builder,
                                    params_path=args.params, **switches)
    else:
        builder = functools.partial(
            flagship_model_builder,
            max_len=args.max_len,
            early_exit=not args.no_early_exit,
            quantize_kv=args.quantize_kv,
            quantize_head=args.quantize_head,
            params_path=args.params,
            batch_size=args.batch_size, **switches)
    worker_device = "cpu" if device.type == "cpu" else None
    server = CaptionServer(
        worker_factory=lambda **kw: CaptioningWorker(
            model_builder=builder, device=worker_device, **kw),
        num_workers=args.n_workers)
    httpd = None
    try:
        server.start()
        print(json.dumps({
            "frontend_addr": server.frontend_addr,
            "sink_pub_addr": server.sink_pub_addr,
            "task": args.task, "n_workers": args.n_workers}), flush=True)
        if args.http_port is not None:
            from news_image_caption_tpu_torch.serving.client import \
                CaptioningClient
            from news_image_caption_tpu_torch.serving.http import serve_http
            client = CaptioningClient(server.frontend_addr,
                                      server.sink_pub_addr,
                                      timeout_ms=900000)
            httpd, port = serve_http(client, args.http_port,
                                     {"task": args.task})
            print(json.dumps({"http_port": port}), flush=True)
        if args.exit_after_ready:
            return 0
        while not guard.triggered:
            time.sleep(0.5)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        if httpd is not None:
            httpd.shutdown()
        server.stop()
        guard.__exit__()


def _texts(tokens: np.ndarray, caption: np.ndarray):
    """(generation, caption) as `w{id}` words: generated ids without bos,
    pad and eos; caption ids without bos, pad and eos."""
    gen_ids = [int(t) for t in tokens if int(t) not in (0, 1)]
    gen_text = " ".join(f"w{t}" for t in gen_ids if t != 2)
    ref_text = " ".join(f"w{int(t)}" for t in caption
                        if int(t) not in (0, 1, 2))
    return gen_text, ref_text


def evaluate(model, ds, gcfg: GenerationConfig, out_dir: str, *,
             batch_size: int, suffix: str = "", enrich: bool = True,
             dump_attention: Optional[str] = None,
             timings: Optional[Dict[str, float]] = None,
             spec_k: int = 0, ngram_n: int = 2) -> Dict:
    """Caption `ds` in batches of `batch_size` (unshuffled, the last
    partial batch dropped) with `model.generate`, or, at spec_k >= 2 and
    where the batch has `article_ids`, `model.generate_speculative`, on
    the model's device, with the decode weights of
    `model.decode_weights()`; write the generations and the metrics to
    `out_dir` and return the metrics. timings, if given, gets the
    host-clock seconds of each span: data (numpy batches), decode
    (staging, generate, tokens back), attention (maps and their files),
    records (texts, enrichment, scorers' inputs, lines), score (corpus
    scores, metrics file)."""
    spans = dict.fromkeys(("data", "decode", "attention", "records",
                           "score"), 0.0)
    device = next(model.param_module.parameters()).device
    staged_keys = getattr(model, "context_keys", CONTEXT_KEYS)
    weights = model.decode_weights()
    if dump_attention and not hasattr(model, "attention_maps"):
        print("warning: model has no attention_maps; skipping dump",
              file=sys.stderr)
        dump_attention = None
    if dump_attention:
        os.makedirs(dump_attention, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    bleu_s, cider_s, rouge_s = BleuScorer(4), CiderScorer(), RougeScorer()
    n = batch_idx = 0
    batches = ds.batches(batch_size, shuffle=False)
    with open(os.path.join(out_dir, f"generations{suffix}.jsonl"), "w") as f:
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            t = _lap(spans, "data", t)
            if batch is None:
                break
            staged = {k: host_tensor(batch[k]).to(device)
                      for k in staged_keys if k in batch}
            if spec_k >= 2 and "article_ids" in batch:
                S = batch["article_ids"].shape[1]
                if batch_idx == 0 and ngram_n > S - 1:
                    print(f"warning: generation.ngram_n={ngram_n} exceeds "
                          f"the article window ({S} tokens); drafts will be "
                          "all-pad and speculative decode pays pure "
                          "overhead", file=sys.stderr)
                staged["article_ids"] = torch.from_numpy(
                    batch["article_ids"]).to(device)
                tokens, aux, _ = model.generate_speculative(
                    staged, gcfg, weights, spec_k=spec_k, ngram_n=ngram_n)
            else:
                tokens, aux = model.generate(staged, gcfg, weights)
            tokens = tokens.to(torch.int32).cpu().numpy()
            # A pointer's copied flags: flags[b, t] marks tokens[b, t+1].
            copied = (aux.cpu().numpy() if aux.dtype == torch.bool
                      else None)
            t = _lap(spans, "decode", t)
            if dump_attention:
                ids = torch.from_numpy(tokens).to(device)
                maps = model.attention_maps(staged, ids)
                arrays = {"tokens": tokens}
                for li, layer_maps in enumerate(maps):
                    for ctx, arr in layer_maps.items():
                        arrays[f"layer{li}_{ctx}"] = arr.float().cpu().numpy()
                np.savez(os.path.join(dump_attention,
                                      f"attn_{batch_idx:05d}.npz"), **arrays)
                t = _lap(spans, "attention", t)
            for b in range(tokens.shape[0]):
                gen_text, ref_text = _texts(tokens[b], batch["caption_ids"][b])
                bleu_s += (gen_text, [ref_text])
                cider_s += (gen_text, [ref_text])
                rouge_s += (gen_text, [ref_text])
                copied_text = "" if copied is None else " ".join(
                    f"w{tokens[b, t + 1]}" for t in range(copied.shape[1])
                    if copied[b, t])
                if enrich:
                    rec = enrich_record(caption=ref_text, generation=gen_text,
                                        copied_text=copied_text)
                else:
                    rec = {"generation": gen_text, "caption": ref_text,
                           "copied_texts": copied_text}
                f.write(json.dumps(rec) + "\n")
                n += 1
            _lap(spans, "records", t)
            batch_idx += 1
    t = time.perf_counter()
    bleu_corpus, _ = bleu_s.compute_score()
    cider_mean, _ = cider_s.compute_score()
    rouge_mean, _ = rouge_s.compute_score()
    metrics = {
        "n_samples": n,
        "bleu-1": bleu_corpus[0] * 100, "bleu-2": bleu_corpus[1] * 100,
        "bleu-3": bleu_corpus[2] * 100, "bleu-4": bleu_corpus[3] * 100,
        "cider": cider_mean, "rouge-l": rouge_mean * 100,
    }
    with open(os.path.join(out_dir, f"evaluate-metrics{suffix}.json"),
              "w") as f:
        json.dump(metrics, f, indent=1)
    _lap(spans, "score", t)
    if timings is not None:
        timings.update(spans)
    return metrics


def _lap(spans: Dict[str, float], name: str, t: float) -> float:
    now = time.perf_counter()
    spans[name] += now - t
    return now


if __name__ == "__main__":
    sys.exit(main())
