"""Captioning worker process and the builders of its predict function.

Counterpart of `news_image_caption_tpu/serving/worker.py`:
`CaptioningWorker` is a spawned process that pulls jobs from the
server's backend, runs `predict(job)` and pushes each result to the
sink; `flagship_model_builder` serves the flagship captioner at the
reference's serving shapes (image 49 x 2048, article 512 x 1024) in
bf16, greedy with early exit; `default_model_builder` serves the
reference's toy model (`--task toy`) in fp32.

Each builder's `predict.stage(job)` moves a job's arrays to the device;
the worker's ingest thread calls it one job ahead of `predict`. On the
card it copies from pinned host memory on a CUDA stream of its own, and
`predict` makes its stream wait for that copy before decoding.

The reference's serving switches: with `speculative_k >= 2`, a job that
carries `article_ids` is decoded by exact speculative greedy
(`generate_speculative`), others greedily. With `continuous_slots > 0`
the builder attaches a slot pool (`generation/continuous.py`) as
`predict.engine`, and the worker runs its continuous loop: requests
enter free slots as they arrive, each answered when its own caption is
done; a job may carry its own `max_len` and, for top-k sampling
(`sampling_topk > 1`, served from the pool only), its `rng_seed`.
`continuous_beam` serves exact beam search from the pool.

`full_model_builder` composes the reference's detection and captioning
of a raw photo: MTCNN faces, their InceptionResnetV1 embeddings and
YOLOv3-SPP object regions (`models/facenet.py`, `models/yolov3.py`),
then the faces (and objects) captioner, returning the caption and the
attention maps of each context; the reference serves it from Python,
not from its `serve` command, and so does the port.

`flagship_model_builder`'s `quantize_kv` / `quantize_head` are the
reference's opt-in int8 routes: int8 context K/V quantized once a
request, int8 head tables quantized once at load (`decode_weights(
quantize_head=True)`), on every path it serves (greedy, speculative,
both slot pools), on the card through `decode_cross_attention_int8` and
`band_topk_lse_int8`.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from news_image_caption_tpu_torch.config import (FLAGSHIP,
                                                 FLAGSHIP_ARTICLE_LEN,
                                                 FLAGSHIP_IMAGE_LEN)
from news_image_caption_tpu_torch.generation.generator import \
    GenerationConfig
from news_image_caption_tpu_torch.models.captioner import \
    TransformerFlattened
from news_image_caption_tpu_torch.models.from_jax import (load_npz,
                                                          params_from_jax)
from news_image_caption_tpu_torch.serving import transport
from news_image_caption_tpu_torch.serving.messages import pack, unpack
from news_image_caption_tpu_torch.utils.logging import setup_logger

# The reference's toy captioner (`default_model_builder`) and its
# request shapes: image 4 x 16, article 6 x 24, 16 decode steps.
TOY = dict(vocab_size=64, cutoff=(16, 32, 64), embed_dim=32, ffn_dim=64,
           num_heads=4, num_layers=2, kernel_sizes=(3, 5), image_dim=16,
           article_dim=24, max_positions=64)
TOY_IMAGE_LEN, TOY_ARTICLE_LEN, TOY_MAX_LEN = 4, 6, 16

_FEATURES = ("image", "article")
_MASKS = ("image_mask", "article_mask")


def check_serving_args(speculative_k: int = 0, continuous_slots: int = 0,
                       continuous_beam: bool = False,
                       sampling_topk: int = 1) -> None:
    """The reference's checks of the serving switches (ValueError)."""
    _check_sampling_args(sampling_topk, continuous_slots, continuous_beam,
                         speculative_k)
    if continuous_beam and continuous_slots <= 0:
        raise ValueError("continuous_beam requires continuous_slots "
                         "> 0 (a plain worker would silently serve "
                         "greedy payloads)")


def _check_sampling_args(sampling_topk: int, continuous_slots: int,
                         continuous_beam: bool,
                         speculative_k: int) -> None:
    """Serving-mode validation for top-k sampling: it is served from
    the slot pool only (per-slot PRNG chains replicate generate's B=1
    key schedule); the plain/beam/speculative paths would silently
    serve something other than what the client asked for."""
    if sampling_topk <= 1:
        return
    if continuous_slots <= 0:
        raise ValueError("sampling_topk > 1 requires continuous_slots "
                         "> 0 (sampling is served from the slot pool)")
    if continuous_beam:
        raise ValueError("sampling_topk > 1 excludes continuous_beam")
    if speculative_k >= 2:
        raise ValueError("sampling_topk > 1 excludes speculative_k "
                         "(the draft-verify commit rule is greedy)")


class Staged(dict):
    """A job's batch on the device; `event` marks the end of its copy
    on the staging stream (None where the copy was synchronous)."""

    event: Optional[torch.cuda.Event] = None


def _pinned(arr: np.ndarray) -> torch.Tensor:
    out = torch.empty(arr.shape, pin_memory=True,
                      dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype)
    out.numpy()[...] = arr
    return out


def _fit_ids(ids: np.ndarray, S: int, pad_id: int = 1) -> np.ndarray:
    """article_ids [B, n] right-padded with pad_id or cut to the served
    article length S: ids past S have no features beside them."""
    ids = np.asarray(ids)
    if ids.shape[1] >= S:
        return ids[:, :S]
    out = np.full((ids.shape[0], S), pad_id, ids.dtype)
    out[:, :ids.shape[1]] = ids
    return out


def await_staging(b: "Staged", device: torch.device) -> None:
    """Order the current stream after a job's staging copy, and tell the
    allocator that it uses the job's tensors (they were allocated on the
    staging stream). A no-op where the copy was synchronous."""
    if b.event is None:
        return
    current = torch.cuda.current_stream(device)
    current.wait_event(b.event)
    for t in b.values():
        if isinstance(t, torch.Tensor):
            t.record_stream(current)


def _serving_predict(model: TransformerFlattened, cfg: GenerationConfig,
                     device: torch.device, dtype: torch.dtype,
                     warmup_job: Dict[str, np.ndarray],
                     speculative_k: int = 0):
    """predict(job) -> {"tokens": int32 [B, max_len + 1]} with `.stage`,
    `.warmup`, `.model`, `.weights` and `.config`. With speculative_k >= 2
    a job's `article_ids` (fitted to the served article length) make
    `predict` decode it by `generate_speculative`. The int8 head tables
    of `cfg.quantize_head` are quantized here, once."""
    weights = model.decoder.decode_weights(cfg.quantize_head)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    S = warmup_job["article"].shape[1]

    def stage(job: Dict[str, Any]) -> Staged:
        # Idempotent: the direct path and the worker's ingest thread
        # share one staging definition.
        if isinstance(job, Staged):
            return job
        arrays = {k: np.asarray(job[k]) for k in _FEATURES}
        arrays.update({k: np.asarray(job[k], bool) for k in _MASKS})
        staged = Staged()
        if stream is None:
            for k, arr in arrays.items():
                t = torch.tensor(arr)
                staged[k] = t.to(dtype) if k in _FEATURES else t
        else:
            with torch.cuda.stream(stream):
                for k, arr in arrays.items():
                    t = _pinned(arr).to(device, non_blocking=True)
                    staged[k] = t.to(dtype) if k in _FEATURES else t
                staged.event = stream.record_event()
        if speculative_k >= 2 and "article_ids" in job:
            # Host ids: the draft source of a speculative job or slot.
            staged["article_ids"] = _fit_ids(
                np.asarray(job["article_ids"], np.int64), S, cfg.pad_id)
        if "max_len" in job:   # per-request cap (continuous engine)
            staged["max_len"] = int(np.asarray(job["max_len"]).ravel()[0])
        if "rng_seed" in job:  # per-request PRNG (sampling slots)
            staged["rng_seed"] = int(np.asarray(job["rng_seed"]).ravel()[0])
        return staged

    def predict(job: Dict[str, Any]) -> Dict[str, Any]:
        b = stage(job)
        if b.pop("max_len", None) is not None:
            # honor-or-reject: the plain path decodes the full
            # config max_len; silently ignoring the cap would lie.
            raise ValueError("per-request max_len requires a "
                             "--continuous-slots worker")
        if b.pop("rng_seed", None) is not None:
            raise ValueError("per-request rng_seed requires a "
                             "--sampling-topk --continuous-slots "
                             "worker")
        ids = b.pop("article_ids", None)
        await_staging(b, device)
        if ids is not None:
            b["article_ids"] = torch.from_numpy(ids).to(device)
            tokens, _, _ = model.generate_speculative(
                b, cfg, weights, spec_k=speculative_k)
        else:
            tokens, _ = model.generate(b, cfg, weights)
        return {"tokens": tokens.to(torch.int32).cpu().numpy()}

    def warmup():
        predict(warmup_job)
        if speculative_k >= 2:
            B = warmup_job["article"].shape[0]
            predict(dict(warmup_job, article_ids=np.ones((B, S), np.int64)))

    predict.stage = stage
    predict.warmup = warmup
    predict.model = model
    predict.weights = weights
    predict.config = cfg
    return predict


def _build_model(dims: Dict[str, Any], device: torch.device,
                 dtype: torch.dtype, params_path: Optional[str],
                 seed: int) -> TransformerFlattened:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; build the model with "
                           "device='cpu' to serve on the CPU")
    generator = torch.Generator(device=device).manual_seed(0)
    model = TransformerFlattened(device=device, dtype=dtype,
                                 generator=generator, **dims)
    if params_path is not None:
        model.decoder.load_state_dict(
            params_from_jax(load_npz(params_path), model.decoder))
    model.decoder.eval()
    return model


def _zero_job(B: int, P: int, S: int, image_dim: int,
              article_dim: int) -> Dict[str, np.ndarray]:
    return {"image": np.zeros((B, P, image_dim), np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": np.zeros((B, S, article_dim), np.float32),
            "article_mask": np.zeros((B, S), bool)}


def _attach_continuous(predict, n_slots: int, inner_steps: int,
                       speculative_k: int, dummy: Dict[str, np.ndarray],
                       beam: bool = False, harvest_lag: int = 1) -> None:
    """Attach a slot pool to a builder's predict as `predict.engine`, and
    a warmup that decodes one dummy request through it (sizing the pool's
    context K/V at the served shapes). The worker then runs its
    continuous loop. beam=True serves exact beam search from the pool
    (`ContinuousBeamBatcher`; results carry [beam, max_len + 1] tokens
    and scores; drafts are greedy-only and not read)."""
    from news_image_caption_tpu_torch.generation.continuous import (
        ContinuousBatcher, ContinuousBeamBatcher)

    model, cfg, weights = predict.model, predict.config, predict.weights
    if beam:
        engine = ContinuousBeamBatcher(model, cfg, n_slots, weights=weights,
                                       inner_steps=inner_steps,
                                       harvest_lag=harvest_lag)
    else:
        engine = ContinuousBatcher.for_flattened(
            model, cfg, n_slots, weights=weights, inner_steps=inner_steps,
            spec_k=max(1, speculative_k), source_len=dummy["article"].shape[1],
            harvest_lag=harvest_lag)
    stage = predict.stage
    device = next(model.decoder.parameters()).device

    def warmup():
        job = stage(dummy)
        await_staging(job, device)
        engine.submit(job)
        engine.run()
        engine.n_chunks = 0
        if hasattr(engine, "n_committed"):
            engine.n_committed = engine.n_slot_steps = 0

    predict.engine = engine
    predict.warmup = warmup


def default_model_builder(device="cuda", params_path: Optional[str] = None,
                          speculative_k: int = 0,
                          continuous_slots: int = 0,
                          inner_steps: int = 8,
                          harvest_lag: int = 1,
                          continuous_beam: bool = False,
                          sampling_topk: int = 1,
                          sampling_temp: float = 1.0):
    """The reference's tiny captioner (smoke and serving tests), fp32,
    16 steps, with the reference's serving switches (see the module).
    params_path: a '/'-joined .npz of the reference's params
    (`load_npz`), e.g. JAX's PRNGKey(0) init; otherwise random weights
    drawn on the CPU from a generator seeded with 0 (the same on every
    device). On the card its decode kernels are the generic variants
    (fp32, head size 8: `route_*` of the ops modules)."""
    check_serving_args(speculative_k, continuous_slots, continuous_beam,
                       sampling_topk)
    device = torch.device(device)
    model = _build_model(TOY, device, torch.float32, params_path, seed=0)
    if params_path is None and device.type != "cpu":
        # The random weights are the CPU generator's draws on every
        # device (a device's generator draws other numbers), so the card
        # serves the same toy as `--platform cpu`.
        model.decoder.load_state_dict(_build_model(
            TOY, torch.device("cpu"), torch.float32, None,
            seed=0).decoder.state_dict())
    cfg = GenerationConfig(max_len=TOY_MAX_LEN, sampling_topk=sampling_topk,
                           sampling_temp=sampling_temp)
    predict = _serving_predict(
        model, cfg, device, torch.float32,
        _zero_job(1, TOY_IMAGE_LEN, TOY_ARTICLE_LEN, TOY["image_dim"],
                  TOY["article_dim"]), speculative_k)
    if continuous_slots > 0:
        _attach_continuous(predict, continuous_slots, inner_steps,
                           speculative_k,
                           _zero_job(1, TOY_IMAGE_LEN, TOY_ARTICLE_LEN,
                                     TOY["image_dim"], TOY["article_dim"]),
                           beam=continuous_beam, harvest_lag=harvest_lag)
    return predict


def flagship_model_builder(device="cuda", max_len: int = 32,
                           early_exit: bool = True,
                           quantize_kv: bool = False,
                           quantize_head: bool = False,
                           params_path: Optional[str] = None,
                           batch_size: int = 1,
                           speculative_k: int = 0,
                           continuous_slots: int = 0,
                           inner_steps: int = 8,
                           harvest_lag: int = 1,
                           continuous_beam: bool = False,
                           sampling_topk: int = 1,
                           sampling_temp: float = 1.0,
                           seed: int = 0):
    """Returns predict(job) -> {"tokens": int32 [B, max_len + 1]}: the
    flagship decoder in bf16 end to end, greedy decode with early exit.

    job: numpy `image` [B, 49, 2048], `image_mask` [B, 49],
    `article` [B, 512, 1024], `article_mask` [B, 512] (masks True at
    padding). params_path: a '/'-joined .npz of the reference's params
    (`models/from_jax.py::load_npz`); otherwise random weights drawn
    from a generator seeded with `seed`. `predict.warmup()` serves one
    zero request of `batch_size` rows (or, with a slot pool, one request
    through it); `predict.stage(job)` moves a job to the device ahead of
    `predict`; `predict.model`, `predict.weights` and `predict.config`
    expose what it runs, `predict.engine` the slot pool. The other
    switches are the reference's (see the module: speculative_k,
    continuous_slots with inner_steps, harvest_lag and continuous_beam,
    sampling_topk with sampling_temp, and the int8 routes quantize_kv
    and quantize_head, which every path takes).
    """
    check_serving_args(speculative_k, continuous_slots, continuous_beam,
                       sampling_topk)
    device = torch.device(device)
    model = _build_model(FLAGSHIP, device, torch.bfloat16, params_path, seed)
    cfg = GenerationConfig(max_len=max_len, early_exit=early_exit,
                           sampling_topk=sampling_topk,
                           sampling_temp=sampling_temp,
                           quantize_kv=quantize_kv,
                           quantize_head=quantize_head)
    predict = _serving_predict(
        model, cfg, device, torch.bfloat16,
        _zero_job(batch_size, FLAGSHIP_IMAGE_LEN, FLAGSHIP_ARTICLE_LEN,
                  FLAGSHIP["image_dim"], FLAGSHIP["article_dim"]),
        speculative_k)
    if continuous_slots > 0:
        _attach_continuous(predict, continuous_slots, inner_steps,
                           speculative_k,
                           _zero_job(1, FLAGSHIP_IMAGE_LEN,
                                     FLAGSHIP_ARTICLE_LEN,
                                     FLAGSHIP["image_dim"],
                                     FLAGSHIP["article_dim"]),
                           beam=continuous_beam, harvest_lag=harvest_lag)
    return predict


def full_model_builder(caption_model=None, caption_params=None,
                       use_faces: bool = True, use_objects: bool = True,
                       gen_config: Optional[GenerationConfig] = None,
                       return_attns: bool = True,
                       yolo_variables=None, facenet_variables=None,
                       max_faces: int = 4, max_objects: int = 16,
                       yolo_img_size: int = 256, device="cuda"):
    """Detection and captioning of a raw photo, as the reference's
    builder composes them: MTCNN face detection, InceptionResnetV1
    embeddings of the faces, YOLOv3-SPP object regions pooled from its
    1024-wide neck, then the captioner over the precomputed image and
    article features and those faces and objects. Returns predict(job)
    -> {"tokens": int32 [1, max_len + 1], "n_faces", "n_objects",
    "obj_boxes" [n, 4], "attn_l{i}_{context}": [1, T, S']} (the keys of
    the parts that ran) with `predict.warmup()`.

    job: `image_raw` [H, W, 3] uint8 (the photo the detectors read),
    `image` [1, P, image_dim] and `article` [1, S, article_dim] features
    with `image_mask` / `article_mask` (True = padding).

    caption_model: a port captioner (`TransformerFlattened` and its
    variants) that holds its weights, on `device`; caption_params, when
    given, the reference's flax tree of it, loaded strictly
    (`params_from_jax`). yolo_variables / facenet_variables: the port's
    state dicts of `YoloV3SPP` / `InceptionResnetV1`
    (`port_darknet_weights`, `port_facenet_pt`); random weights drawn
    from a generator seeded with 0 otherwise, as for MTCNN's nets.

    Faces fill `max_faces` slots of 512 and objects `max_objects` slots
    of 1024, NaN where nothing was found, masked through
    `models/variants.py::nan_to_mask`. The objects are the neck's
    1024-wide features, so only a model whose `obj` context is 1024
    wide consumes them (the configs' `obj_dim` is 2048): as in the
    reference, a model of another width fails, here before anything is
    built. The detectors run in float32 without TF32
    (`models/facenet.py::fp32_exact`); the caption decodes on the
    model's kernels (greedy, `generate`), the maps come from
    `attention_maps` over the generated tokens.
    """
    from news_image_caption_tpu_torch.models.facenet import (
        MTCNN, InceptionResnetV1, build_net, embed_faces)
    from news_image_caption_tpu_torch.models.variants import nan_to_mask
    from news_image_caption_tpu_torch.models.yolov3 import \
        ObjectFeatureExtractor

    device = torch.device(device)
    dims = {}
    if caption_model is not None:
        layer = caption_model.decoder.all_layers()[0]
        dims = {name: layer._attn(name).k_proj.kernel.shape[0]
                for name in layer.context_names}
        for name, width in (("faces", 512), ("obj", 1024)):
            if name in dims and dims[name] != width:
                raise ValueError(
                    f"full_model_builder: the detectors give {width}-wide "
                    f"{name} features; this model's {name} context is "
                    f"{dims[name]} wide")
        if caption_params is not None:
            module = caption_model.param_module
            module.load_state_dict(params_from_jax(caption_params, module))
        caption_model.param_module.eval()
        weights = caption_model.decode_weights()
        param = next(caption_model.param_module.parameters())
    generator = torch.Generator(device=device).manual_seed(0)
    det = dict(device=device, generator=generator)
    mtcnn = MTCNN(**det) if use_faces else None
    embedder = (build_net(InceptionResnetV1, facenet_variables, **det)
                if use_faces else None)
    objector = (ObjectFeatureExtractor(yolo_variables, yolo_img_size, **det)
                if use_objects else None)
    cfg = gen_config or GenerationConfig(max_len=32)
    with_maps = return_attns and hasattr(caption_model, "attention_maps")

    def context(feats: np.ndarray):
        f, m = nan_to_mask(torch.from_numpy(feats)[None])
        return f.to(param.device, param.dtype), m.to(param.device)

    def predict(job: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        img = job.get("image_raw")
        faces = np.full((max_faces, 512), np.nan, np.float32)
        objs = np.full((max_objects, 1024), np.nan, np.float32)
        if use_faces and img is not None:
            boxes, _ = mtcnn.detect(img)
            crops = mtcnn.extract_faces(img, boxes[:max_faces])
            if len(crops):
                emb = embed_faces(embedder, crops)
                faces[:len(emb)] = emb
            out["n_faces"] = np.asarray(len(crops))
        if use_objects and img is not None:
            obj_boxes, obj_feats = objector(img)
            n = min(len(obj_feats), max_objects)
            objs[:n] = obj_feats[:n]
            out["n_objects"] = np.asarray(n)
            out["obj_boxes"] = np.asarray(obj_boxes[:n], np.float32)
        if caption_model is None:
            return out
        batch = {}
        for k in _FEATURES + _MASKS:
            if k in job:
                t = torch.from_numpy(np.asarray(
                    job[k], bool if k in _MASKS else np.float32))
                batch[k] = t.to(param.device,
                                None if k in _MASKS else param.dtype)
        if "faces" in dims:
            batch["faces"], batch["faces_mask"] = context(faces)
        if "obj" in dims:
            batch["obj"], batch["obj_mask"] = context(objs)
        tokens, _ = caption_model.generate(batch, cfg, weights)
        out["tokens"] = tokens.to(torch.int32).cpu().numpy()
        if with_maps:
            maps = caption_model.attention_maps(batch, tokens[:, :-1])
            for li, layer_maps in enumerate(maps):
                for cname, attn in layer_maps.items():
                    out[f"attn_l{li}_{cname}"] = attn.float().cpu().numpy()
        return out

    def warmup():
        """Serve one zero job without a photo, as the reference's warmup
        (no detector runs)."""
        if caption_model is None:
            return
        job = _zero_job(1, 49, 512, dims.get("image", 2048),
                        dims["article"])
        if "image" not in dims:
            del job["image"], job["image_mask"]
        predict(job)

    predict.warmup = warmup
    predict.mtcnn, predict.embedder, predict.objector = (mtcnn, embedder,
                                                         objector)
    return predict


def decode_launches() -> Dict[str, int]:
    """Launch counts of the four decode kernels, the two int8 variants
    and the six generic variants (the int8 ones' included) in this
    process."""
    from news_image_caption_tpu_torch.ops import (band_topk,
                                                  decode_attention,
                                                  decode_blocks)
    return {"band_topk_lse": band_topk.band_topk_lse.launches,
            "decode_cross_attention":
                decode_attention.decode_cross_attention.launches,
            "decode_conv_block": decode_blocks.decode_conv_block.launches,
            "decode_ffn_block": decode_blocks.decode_ffn_block.launches,
            "band_topk_lse_int8": band_topk.band_topk_lse_int8.launches,
            "decode_cross_attention_int8":
                decode_attention.decode_cross_attention_int8.launches,
            "band_topk_lse_generic":
                band_topk.band_topk_lse_generic.launches,
            "decode_cross_attention_generic":
                decode_attention.decode_cross_attention_generic.launches,
            "decode_conv_block_generic":
                decode_blocks.decode_conv_block_generic.launches,
            "decode_ffn_block_generic":
                decode_blocks.decode_ffn_block_generic.launches,
            "band_topk_lse_int8_generic":
                band_topk.band_topk_lse_int8_generic.launches,
            "decode_cross_attention_int8_generic":
                decode_attention.decode_cross_attention_int8_generic.launches}


def is_cuda_error(e: BaseException) -> bool:
    """An error of the CUDA context, which the worker treats as fatal: a
    sticky error poisons the context, and every later job would fail
    or be served from a broken one. Out-of-memory is not one."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    return (isinstance(e, torch.cuda.CudaError)
            or (accelerator_error is not None
                and isinstance(e, accelerator_error))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e)))


_MP = multiprocessing.get_context("spawn")


class CaptioningWorker(_MP.Process):
    """device: where the worker decodes: None, the card (worker i on
    card i modulo the count, as the reference pins one worker a chip),
    or "cpu" when asked. model_builder(device=...) returns predict
    (default: the toy, `default_model_builder`)."""

    def __init__(self, worker_id: int, receive_addr: str, sink_addr: str,
                 model_builder: Optional[Callable] = None,
                 device: Optional[str] = None):
        super().__init__()
        self.worker_id = worker_id
        self.receive_addr = receive_addr
        self.sink_addr = sink_addr
        self.model_builder = model_builder or default_model_builder
        self.device = device
        self.daemon = True

    def _device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the worker; pass "
                               "device='cpu' to serve on the CPU")
        device = torch.device("cuda",
                              self.worker_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        return device

    def run(self):
        logger = setup_logger(f"worker-{self.worker_id}")
        device = self._device()
        predict = self.model_builder(device=device)
        # Builders may expose .warmup() so the first real job does not
        # pay the first call's costs.
        warmup = getattr(predict, "warmup", None)
        if warmup is not None:
            warmup()
        # Builders may expose .stage(job) -> staged input: work that
        # should overlap with the PREVIOUS job's compute, the host to
        # device copy of the features. The ingest thread runs recv +
        # unpack + stage one job ahead of the predict loop.
        stage = getattr(predict, "stage", None)
        receiver = transport.Socket(transport.PULL)
        receiver.connect(self.receive_addr)
        sink = transport.Socket(transport.PUSH)
        sink.connect(self.sink_addr)
        staged_q: "queue.Queue" = queue.Queue(maxsize=2)

        def ingest():
            while True:
                try:
                    frames = receiver.recv_multipart()
                except transport.Closed:
                    return
                try:
                    client_id, job_id = frames[0], frames[1]
                except IndexError:
                    logger.warning("dropping short multipart message "
                                   "(%d frames)", len(frames))
                    continue   # the thread must outlive bad clients
                try:
                    job = unpack(frames[2:])
                    # Stats RPC: no feature tensors, must not hit
                    # stage() (it would KeyError on "image").
                    if not job.get("_stats") and stage is not None:
                        job = stage(job)
                    staged_q.put((client_id, job_id, job, None))
                except Exception as e:   # malformed job / bad stage
                    staged_q.put((client_id, job_id, None, e))

        threading.Thread(target=ingest, daemon=True).start()
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        logger.info("worker %d ready on %s (%s)", self.worker_id, device,
                    name)
        t_ready = time.monotonic()
        n_served = 0
        engine = getattr(predict, "engine", None)
        try:
            if engine is not None:
                self._continuous_loop(engine, staged_q, sink, logger, device,
                                      t_ready)
                return
            while True:
                client_id, job_id, job, err = staged_q.get()
                if err is None and job.get("_stats"):
                    result = {"mode": "plain",
                              "worker_id": self.worker_id,
                              "jobs_served": n_served,
                              "uptime_s": round(
                                  time.monotonic() - t_ready, 1),
                              "kernel_launches": decode_launches()}
                elif err is None:
                    try:
                        result = predict(job)
                        n_served += 1
                    except Exception as e:  # report errors to client
                        err = e
                if err is not None:
                    result = {"error": repr(err)}
                sink.send_multipart([client_id, job_id] + pack(result))
                if err is not None and is_cuda_error(err):
                    # Reply first, then exit non-zero so that the server's
                    # monitor starts a worker with a fresh context.
                    logger.error("worker %d: CUDA error, exiting: %r",
                                 self.worker_id, err)
                    sink.close(linger=10000)
                    os._exit(1)
        finally:
            receiver.close(linger=0)
            sink.close()

    def _exit_on_cuda_error(self, sink, logger, err: BaseException) -> None:
        """After a CUDA error (replies sent), exit non-zero so that the
        server's monitor starts a worker with a fresh context."""
        if is_cuda_error(err):
            logger.error("worker %d: CUDA error, exiting: %r",
                         self.worker_id, err)
            sink.close(linger=10000)
            os._exit(1)

    def _reply_error(self, sink, logger, client_id, job_id,
                     err: BaseException) -> None:
        sink.send_multipart([client_id, job_id] + pack({"error": repr(err)}))
        self._exit_on_cuda_error(sink, logger, err)

    def _continuous_loop(self, engine, staged_q, sink, logger, device,
                         t_ready: float) -> None:
        """Serve from a slot pool: submit staged jobs as they arrive,
        dispatch the pool, and push each caption to the sink when its own
        slot is done (the plain loop answers strictly in order; here a
        short caption never waits behind a long one)."""
        from news_image_caption_tpu_torch.generation.continuous import \
            ContinuousBeamBatcher
        is_beam = isinstance(engine, ContinuousBeamBatcher)
        sampling = engine.config.sampling_topk > 1
        pending: Dict[int, tuple] = {}
        while True:
            # Block for work only when idle; while slots decode, take what
            # has arrived without waiting, until the engine's queue is full
            # (staged features hold device memory; more jobs wait as bytes
            # in the transport, as the plain loop's staged_q bounds them).
            block = not pending
            while engine.backlog < engine.max_queue:
                try:
                    item = staged_q.get(block=block)
                except queue.Empty:
                    break
                block = False
                client_id, job_id, job, err = item
                if err is not None:
                    self._reply_error(sink, logger, client_id, job_id, err)
                    continue
                if job.get("_stats"):
                    stats = {"mode": "continuous",
                             "worker_id": self.worker_id,
                             "in_flight": len(pending),
                             "uptime_s": round(time.monotonic() - t_ready,
                                               1),
                             "kernel_launches": decode_launches(),
                             **engine.stats()}
                    sink.send_multipart([client_id, job_id] + pack(stats))
                    continue
                try:
                    src = job.pop("article_ids", None)
                    if src is not None:
                        src = np.asarray(src)[0]   # [1, S] -> [S]
                    max_len = job.pop("max_len", None)
                    seed = job.pop("rng_seed", None)
                    await_staging(job, device)
                    if is_beam:   # exact beam reads no drafts, no seed
                        if seed is not None:
                            raise ValueError(
                                "rng_seed requires a --sampling-topk worker "
                                "(this one serves exact beam)")
                        rid = engine.submit(job, max_len=max_len)
                    else:
                        # The request's seed, else its id, seeds its
                        # slot's generator; greedy slots draw nothing.
                        gen = None
                        if sampling and seed is not None:
                            gen = torch.Generator(
                                device=engine.device).manual_seed(int(seed))
                        rid = engine.submit(job, source_row=src,
                                            max_len=max_len, generator=gen)
                    pending[rid] = (client_id, job_id)
                except Exception as e:   # report errors to the client
                    self._reply_error(sink, logger, client_id, job_id, e)
            if not pending:
                continue
            try:
                done = engine.step()
            except Exception as e:
                # step() reset the engine: every request in flight is
                # lost. Fail them all and go on serving on the fresh pool.
                logger.exception("continuous engine step failed; engine "
                                 "reset")
                failed, pending = list(pending.values()), {}
                for client_id, job_id in failed:
                    sink.send_multipart([client_id, job_id]
                                        + pack({"error": repr(e)}))
                self._exit_on_cuda_error(sink, logger, e)
                continue
            # A malformed request fails alone. pop(rid, None): an unknown
            # id (one from before a reset) must not end the loop.
            for rid, e in engine.drain_failed().items():
                entry = pending.pop(rid, None)
                if entry is not None:
                    sink.send_multipart(list(entry)
                                        + pack({"error": repr(e)}))
            for rid, (toks, aux) in done.items():
                entry = pending.pop(rid, None)
                if entry is None:
                    continue
                if is_beam:   # [1, beam, L+1] tokens, [1, beam] scores
                    payload = {"tokens": toks[None].astype(np.int32),
                               "scores": aux[None]}
                else:         # [1, L+1] tokens
                    payload = {"tokens": toks[None].astype(np.int32)}
                sink.send_multipart(list(entry) + pack(payload))
