"""The port's serving stack against the reference's, on the CPU.

The wire format and the HTTP proxy are held equal to the reference's
byte for byte. The port's own transport (no zmq) is tested by role. A
server with the toy worker, its weights JAX's PRNGKey(0) init carried
across as an `.npz`, serves tokens equal to the reference model's
`generate` on the same jobs, and mirrors `tests/test_serving.py` case
for case. The file spawns two worker processes (the module's server and
its respawn) and two `serve` commands.
"""

import ast
import functools
import glob
from http.client import HTTPConnection
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from news_image_caption_tpu.generation.generator import \
    GenerationConfig as JaxGenerationConfig  # noqa: E402
from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened  # noqa: E402
from news_image_caption_tpu.serving import http as jax_http  # noqa: E402
from news_image_caption_tpu.serving import messages as jax_messages  # noqa: E402
from news_image_caption_tpu_torch import cli  # noqa: E402
from news_image_caption_tpu_torch.serving import (http, messages,  # noqa: E402
                                                  transport, worker)
from news_image_caption_tpu_torch.serving.base import (  # noqa: E402
    CaptionServer, ServerCmd, auto_bind)
from news_image_caption_tpu_torch.serving.client import \
    CaptioningClient  # noqa: E402
from news_image_caption_tpu_torch.serving.worker import (  # noqa: E402
    TOY, TOY_ARTICLE_LEN, TOY_IMAGE_LEN, TOY_MAX_LEN, CaptioningWorker,
    default_model_builder)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "news_image_caption_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so that the suite's parallel
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the wire format ------------------------------------------------------

WIRE_CASES = {
    "arrays_and_json": {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b": "hello", "c": [1, 2, 3], "d": np.array([True, False])},
    "tokens": {"tokens": np.array([[0, 5, 9, 2, 1]], np.int32)},
    "scalars_and_empty": {"x": np.float64(1.5).reshape(()),
                          "e": np.zeros((0, 3), np.int64), "n": None,
                          "f": 2.5},
    "bfloat16": {"attn": np.asarray([[1.5, -2.25], [0.0, 3.0]],
                                    ml_dtypes.bfloat16)},
    "error": {"error": "KeyError('image')"},
}


@pytest.mark.parametrize("name", sorted(WIRE_CASES))
def test_pack_frames_equal_reference(name):
    obj = WIRE_CASES[name]
    frames = messages.pack(obj)
    assert frames == jax_messages.pack(obj)
    out, ref = messages.unpack(frames), jax_messages.unpack(frames)
    assert out.keys() == ref.keys()
    for k in out:
        if isinstance(ref[k], np.ndarray):
            assert out[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(out[k], ref[k])
        else:
            assert out[k] == ref[k]


def test_pack_upcasts_bfloat16_for_vanilla_numpy_clients():
    x = WIRE_CASES["bfloat16"]["attn"]
    frames = messages.pack({"attn": x})
    assert json.loads(frames[0])["keys"]["attn"]["dtype"] == "float32"
    np.testing.assert_array_equal(messages.unpack(frames)["attn"],
                                  x.astype(np.float32))


# -- the transport ----------------------------------------------------------

@pytest.fixture
def ipc_dirs():
    dirs = []
    yield dirs
    for d in dirs:
        for f in glob.glob(os.path.join(d, "*")):
            os.unlink(f)
        os.rmdir(d)


def _bound(kind, dirs, **kw):
    sock = transport.Socket(kind, **kw)
    return sock, auto_bind(sock, dirs)


def _connected(kind, addr, prefixes=()):
    sock = transport.Socket(kind)
    for p in prefixes:
        sock.subscribe(p)
    sock.connect(addr)
    return sock


def _recv(sock, timeout_ms=5000):
    assert sock.poll(timeout_ms), "no message within the timeout"
    return sock.recv_multipart()


def test_fan_out_round_robin_over_two_pullers(ipc_dirs):
    push, addr = _bound(transport.PUSH, ipc_dirs, send_timeout_ms=5000)
    pulls = [_connected(transport.PULL, addr) for _ in range(2)]
    big = bytes(range(256)) * 16384           # 4 MiB, one frame
    try:
        for i in range(6):
            push.send_multipart([b"m%d" % i, big, b""])
        for j, pull in enumerate(pulls):
            got = [_recv(pull) for _ in range(3)]
            assert [f[0] for f in got] == [b"m%d" % i
                                           for i in range(j, 6, 2)]
            assert all(f[1] == big and f[2] == b"" for f in got)
            assert not pull.poll(50)
    finally:
        for s in (push, *pulls):
            s.close(linger=0)


def test_fan_in_from_many_pushers(ipc_dirs):
    pull, addr = _bound(transport.PULL, ipc_dirs)
    pushes = [_connected(transport.PUSH, addr) for _ in range(4)]
    try:
        for i, push in enumerate(pushes):
            for j in range(5):
                push.send_multipart([b"%d" % i, b"%d" % j])
        got = [_recv(pull) for _ in range(20)]
        for i in range(4):    # each sender's messages arrive in order
            assert [f[1] for f in got if f[0] == b"%d" % i] == [
                b"%d" % j for j in range(5)]
        assert not pull.poll(50)
    finally:
        for s in (pull, *pushes):
            s.close(linger=0)


def test_many_threads_lose_no_message(ipc_dirs):
    """Stress: 16 sender threads (more than the cores) through one bound
    PULL, relayed by a bound PUSH to 3 pullers, with a short switch
    interval: every message arrives exactly once."""
    n_senders, n_msgs = 16, 150
    pull, addr = _bound(transport.PULL, ipc_dirs)
    push, out_addr = _bound(transport.PUSH, ipc_dirs, send_timeout_ms=5000)
    pullers = [_connected(transport.PULL, out_addr) for _ in range(3)]
    pushes = [_connected(transport.PUSH, addr) for _ in range(n_senders)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def send(i):
            for j in range(n_msgs):
                pushes[i].send_multipart([b"%d" % i, b"%d" % j])

        received = [[] for _ in pullers]

        def drain(k):
            while pullers[k].poll(1000):
                received[k].append(pullers[k].recv_multipart())

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(n_senders)]
        threads += [threading.Thread(target=drain, args=(k,))
                    for k in range(len(pullers))]
        for t in threads:
            t.start()
        for _ in range(n_senders * n_msgs):    # the relay
            push.send_multipart(_recv(pull))
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        got = {i: [] for i in range(n_senders)}
        for msgs in received:
            for i, j in msgs:
                got[int(i)].append(int(j))
        counts = [len(msgs) for msgs in received]
        assert sum(counts) == n_senders * n_msgs
        assert min(counts) > 0
        for i in range(n_senders):
            assert sorted(got[i]) == list(range(n_msgs))
    finally:
        sys.setswitchinterval(old)
        for s in (pull, push, *pullers, *pushes):
            s.close(linger=0)


def test_pub_sub_prefix_filter(ipc_dirs):
    pub, addr = _bound(transport.PUB, ipc_dirs)
    # connect returns once the sink holds the filter: nothing is lost to
    # a slow join, with no sleep.
    subs = {b"aa": _connected(transport.SUB, addr, [b"aa"]),
            b"ab": _connected(transport.SUB, addr, [b"ab"]),
            b"all": _connected(transport.SUB, addr, [b""])}
    try:
        for first in (b"aa-1", b"ab-1", b"zz-1", b"aa-2"):
            pub.send_multipart([first, b"payload"])
        assert [_recv(subs[b"aa"])[0] for _ in range(2)] == [b"aa-1",
                                                             b"aa-2"]
        assert _recv(subs[b"ab"])[0] == b"ab-1"
        assert [_recv(subs[b"all"])[0] for _ in range(4)] == [
            b"aa-1", b"ab-1", b"zz-1", b"aa-2"]
        assert not any(s.poll(50) for s in subs.values())
    finally:
        for s in (pub, *subs.values()):
            s.close(linger=0)


def test_poll_timeout(ipc_dirs):
    pull, addr = _bound(transport.PULL, ipc_dirs)
    try:
        t = time.monotonic()
        assert pull.poll(150) is False
        assert 0.14 <= time.monotonic() - t < 2.0
    finally:
        pull.close(linger=0)


def test_send_timeout_without_puller(ipc_dirs):
    push, _ = _bound(transport.PUSH, ipc_dirs, send_timeout_ms=150)
    try:
        t = time.monotonic()
        with pytest.raises(transport.Again):
            push.send_multipart([b"job"])
        assert 0.14 <= time.monotonic() - t < 2.0
    finally:
        push.close(linger=0)


def test_send_timeout_with_full_outbox(ipc_dirs, monkeypatch):
    """A puller that reads nothing: the PUSH fills its outbox and the
    socket buffers, then times out instead of blocking the relay."""
    monkeypatch.setattr(transport, "HWM", 2)
    push, addr = _bound(transport.PUSH, ipc_dirs, send_timeout_ms=150)
    pull = _connected(transport.PULL, addr)
    frame = b"x" * (1 << 20)
    try:
        with pytest.raises(transport.Again):
            for _ in range(64):
                push.send_multipart([frame])
        assert _recv(pull)[0] == frame
    finally:
        push.close(linger=0)
        pull.close(linger=0)


def test_connect_rejects_a_wrong_role(ipc_dirs):
    pull, addr = _bound(transport.PULL, ipc_dirs)
    try:
        with pytest.raises(ConnectionError, match="takes push"):
            _connected(transport.PULL, addr)
    finally:
        pull.close(linger=0)


def test_close_leaves_no_ipc_dirs():
    dirs = []
    pull, addr = _bound(transport.PULL, dirs)
    pub, pub_addr = _bound(transport.PUB, dirs)
    push = _connected(transport.PUSH, addr)
    sub = _connected(transport.SUB, pub_addr, [b""])
    push.send_multipart([b"last"])
    push.close()                    # lingers until the message is written
    assert _recv(pull) == [b"last"]
    for s in (pull, pub, sub):
        s.close(linger=0)
    for d in dirs:
        assert os.path.basename(d).startswith("tellax-ipc-")
        assert os.listdir(d) == []  # the bound sockets' files are gone
        os.rmdir(d)
    with pytest.raises(transport.Closed):
        pull.recv_multipart()


# -- the HTTP proxy ---------------------------------------------------------

class FakeClient:
    """Stands in for CaptioningClient behind both packages' handlers."""

    def caption(self, job):
        if "boom" in job:
            raise RuntimeError("worker said no")
        return {"tokens": np.array([[0, 5, 9, 2, 1]], np.int32),
                "keys": sorted(job),
                "dtypes": {k: str(v.dtype) for k, v in sorted(job.items())
                           if isinstance(v, np.ndarray)}}

    def stats(self):
        if getattr(self, "broken", False):
            raise TimeoutError("no worker answered")
        return {"mode": "plain", "worker_id": 0, "jobs_served": 3,
                "uptime_s": 1.5}


_JOB = {"image": {"data": [[[0.5, 1.0]]], "dtype": "float32"},
        "article_mask": {"data": [[False, True]], "dtype": "bool"},
        "note": "plain json"}
HTTP_CASES = {
    "encode": ("POST", "/encode", json.dumps(_JOB)),
    "encode_stats_stripped": ("POST", "/encode",
                              json.dumps(dict(_JOB, _stats=True))),
    "encode_error": ("POST", "/encode", json.dumps(dict(_JOB, boom=1))),
    "encode_bad_json": ("POST", "/encode", "{not json"),
    "post_404": ("POST", "/other", "{}"),
    "status": ("GET", "/status", None),
    "status_sub": ("GET", "/status/anything", None),
    "status_worker": ("GET", "/status/worker", None),
    "status_worker_down": ("GET", "/status/worker", None),
    "get_404": ("GET", "/nope", None),
}


def _http(port, method, path, body):
    conn = HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def proxies():
    """Both packages' HTTP proxies, each over its own FakeClient."""
    out = []
    for module in (http, jax_http):
        client = FakeClient()
        out.append((client, *module.serve_http(
            client, server_info={"model": "tiny"})))
    yield out
    for _, httpd, _ in out:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("name", sorted(HTTP_CASES))
def test_http_handler_matches_reference(name, proxies):
    method, path, body = HTTP_CASES[name]
    answers = []
    for client, _, port in proxies:
        client.broken = name == "status_worker_down"
        answers.append(_http(port, method, path, body))
    assert answers[0] == answers[1]
    if name == "encode_stats_stripped":
        assert answers[0][0] == 200
        assert "_stats" not in json.loads(answers[0][2])["keys"]


# -- the builders -------------------------------------------------------------

@pytest.mark.parametrize("kwargs, error, match", [
    (dict(continuous_beam=True), ValueError, "continuous_slots"),
    (dict(sampling_topk=2), ValueError, "continuous_slots"),
    (dict(sampling_topk=4, continuous_slots=2, continuous_beam=True),
     ValueError, "excludes continuous_beam"),
    (dict(sampling_topk=4, continuous_slots=2, speculative_k=4), ValueError,
     "excludes speculative_k"),
])
def test_flagship_builder_switches_raise(kwargs, error, match):
    """The reference's ValueErrors, all before a model is built (so on
    the meta device too, and fast)."""
    with pytest.raises(error, match=match):
        worker.flagship_model_builder("meta", **kwargs)


# The flagship's structure at the toy's widths: the builders' int8 routes
# run on the CPU in a second.
NARROW = dict(TOY, cutoff=(16, 32, 64), num_heads=4)


@pytest.fixture
def narrow_flagship(monkeypatch):
    """`flagship_model_builder` at the toy's widths and request shapes,
    and the int8 plain twins counting their calls: {name: calls}."""
    from news_image_caption_tpu_torch.ops import band_topk, decode_attention

    monkeypatch.setattr(worker, "FLAGSHIP", NARROW)
    monkeypatch.setattr(worker, "FLAGSHIP_IMAGE_LEN", TOY_IMAGE_LEN)
    monkeypatch.setattr(worker, "FLAGSHIP_ARTICLE_LEN", TOY_ARTICLE_LEN)
    calls = {}
    for module, name in ((decode_attention,
                          "decode_cross_attention_int8_plain"),
                         (band_topk, "band_topk_lse_int8_plain")):
        def counting(*args, _fn=getattr(module, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(module, name, counting)
    return calls


def _quantized_route_runs(predict, calls, quantize_kv, quantize_head):
    """predict serves a job through the int8 routes its switches name:
    tokens of the quantized `generate` on the staged job, each int8
    twin called exactly where its switch is on."""
    job = make_job(3, article_len=4)
    cfg = predict.config
    assert (cfg.quantize_kv, cfg.quantize_head) == (quantize_kv,
                                                   quantize_head)
    assert (predict.weights.quant_tables is not None) == quantize_head
    calls.clear()
    tokens = predict(job)["tokens"]
    assert tokens.shape == (1, cfg.max_len + 1) and tokens[0, 0] == 0
    assert ("decode_cross_attention_int8_plain" in calls) == quantize_kv
    assert ("band_topk_lse_int8_plain" in calls) == quantize_head
    staged = predict.stage(job)
    want, _ = predict.model.generate(staged, cfg, predict.weights)
    np.testing.assert_array_equal(tokens, want.numpy())


@pytest.mark.parametrize("quantize_kv,quantize_head", [
    (True, False), (False, True), (True, True)])
def test_flagship_builder_quantized_routes(narrow_flagship, quantize_kv,
                                           quantize_head):
    """`flagship_model_builder(quantize_kv=..., quantize_head=...)` builds
    (the head tables quantized once, at load) and serves through the
    int8 routes, on the CPU at the toy's widths."""
    predict = worker.flagship_model_builder(
        "cpu", max_len=6, quantize_kv=quantize_kv,
        quantize_head=quantize_head)
    predict.warmup()
    _quantized_route_runs(predict, narrow_flagship, quantize_kv,
                          quantize_head)


def test_sampling_args_validation():
    """The reference's `test_sampling_args_validation`, on the toy."""
    with pytest.raises(ValueError):   # needs the slot pool
        default_model_builder("cpu", sampling_topk=4)
    with pytest.raises(ValueError):   # beam is exact, not sampled
        default_model_builder("cpu", sampling_topk=4, continuous_slots=2,
                              continuous_beam=True)
    with pytest.raises(ValueError):   # draft-verify commit is greedy
        default_model_builder("cpu", sampling_topk=4, continuous_slots=2,
                              speculative_k=4)


def test_toy_refuses_the_card():
    """The toy serves on the card (its kernels are the generic variants);
    where there is no card it raises as the flagship does."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_model_builder("cuda")


def test_is_cuda_error():
    assert worker.is_cuda_error(RuntimeError(
        "decode_ffn_block: CUDA error 700 (an illegal memory access)"))
    assert worker.is_cuda_error(RuntimeError("CUDA error: device-side "
                                             "assert triggered"))
    assert not worker.is_cuda_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not worker.is_cuda_error(ValueError("head size 8 is not "
                                               "admitted"))
    assert not worker.is_cuda_error(KeyError("image"))


# -- the toy captioner against the reference's ------------------------------

def make_job(seed=0, B=1, article_len=TOY_ARTICLE_LEN):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, TOY_ARTICLE_LEN), bool)
    mask[:, article_len:] = True
    return {
        "image": rng.standard_normal(
            (B, TOY_IMAGE_LEN, TOY["image_dim"])).astype(np.float32),
        "image_mask": np.zeros((B, TOY_IMAGE_LEN), bool),
        "article": rng.standard_normal(
            (B, TOY_ARTICLE_LEN, TOY["article_dim"])).astype(np.float32),
        "article_mask": mask,
    }


JOBS = [make_job(0), make_job(1, article_len=3), make_job(2, B=2),
        make_job(3, article_len=1)]


@pytest.fixture(scope="module")
def reference():
    """The reference's toy (`default_model_builder`'s model and init),
    its params saved as the '/'-joined .npz the port loads, and its
    greedy tokens for JOBS."""
    model = JaxTransformerFlattened(**TOY)
    init = {"caption_ids": jnp.zeros((1, 8), jnp.int32),
            "image": jnp.zeros((1, TOY_IMAGE_LEN, TOY["image_dim"])),
            "image_mask": jnp.zeros((1, TOY_IMAGE_LEN), bool),
            "article": jnp.zeros((1, TOY_ARTICLE_LEN, TOY["article_dim"])),
            "article_mask": jnp.zeros((1, TOY_ARTICLE_LEN), bool)}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), init)
    cfg = JaxGenerationConfig(max_len=TOY_MAX_LEN)
    gen = jax.jit(lambda b: model.generate(params, b, cfg)[0])
    tokens = [np.asarray(gen({k: jnp.asarray(v) for k, v in job.items()}))
              for job in JOBS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "toy.npz")
        np.savez(path, **{"/".join(k): np.asarray(v)
                          for k, v in flatten_dict(params).items()})
        yield {"params_path": path, "tokens": tokens}


def test_toy_builder_matches_reference_generate(reference):
    predict = default_model_builder("cpu",
                                    params_path=reference["params_path"])
    predict.warmup()
    for job, want in zip(JOBS, reference["tokens"]):
        got = predict(job)["tokens"]
        assert got.dtype == np.int32
        assert got.shape == (job["image"].shape[0], TOY_MAX_LEN + 1)
        np.testing.assert_array_equal(got, want)
        # stage is idempotent; predict takes a staged job as it is
        staged = predict.stage(job)
        assert predict.stage(staged) is staged
        np.testing.assert_array_equal(predict(staged)["tokens"], want)
    for key in ("max_len", "rng_seed"):   # honor-or-reject
        with pytest.raises(ValueError, match=key):
            predict(dict(JOBS[0], **{key: np.array([3])}))


def test_worker_replies_then_exits_on_a_cuda_error(ipc_dirs, monkeypatch):
    """A CUDA error poisons the context: the worker sends the job's
    error reply, then exits non-zero so that the monitor respawns it.
    Any other error stays a per-job reply. The worker's loop runs here
    in a thread, its exit caught."""
    backend, backend_addr = _bound(transport.PUSH, ipc_dirs,
                                   send_timeout_ms=5000)
    sink, sink_addr = _bound(transport.PULL, ipc_dirs)
    exits = []

    def exit_(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(worker.os, "_exit", exit_)
    w = CaptioningWorker(0, backend_addr, sink_addr, device="cpu",
                         model_builder=_failing_builder)
    t = threading.Thread(target=lambda: pytest.raises(SystemExit, w.run),
                         daemon=True)
    t.start()
    try:
        backend.send_multipart([b"c", b"1"] + messages.pack({"fail": 0}))
        backend.send_multipart([b"c", b"2"] + messages.pack({"fail": 1}))
        first = _recv(sink, 30000)
        assert first[:2] == [b"c", b"1"]
        assert messages.unpack(first[2:]) == {
            "error": "ValueError('not a CUDA error')"}
        second = _recv(sink, 30000)
        assert second[:2] == [b"c", b"2"]
        assert "CUDA error 700" in messages.unpack(second[2:])["error"]
        t.join(timeout=30)
        assert not t.is_alive() and exits == [1]
    finally:
        backend.close(linger=0)
        sink.close(linger=0)


def _failing_builder(device):
    def predict(job):
        if job["fail"]:
            raise RuntimeError("fake_kernel: CUDA error 700 (an illegal "
                               "memory access was encountered)")
        raise ValueError("not a CUDA error")
    return predict


# -- a server with the toy worker ---------------------------------------------

@pytest.fixture(scope="module")
def server_and_client(reference):
    # One intra-op thread in the worker: the toy's ops are tiny, and the
    # tier-1 run shares the cores between its pytest workers.
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    builder = functools.partial(default_model_builder,
                                params_path=reference["params_path"])
    try:
        server = CaptionServer(
            worker_factory=lambda **kw: CaptioningWorker(
                model_builder=builder, device="cpu", **kw),
            num_workers=1).start()
        client = CaptioningClient(server.frontend_addr,
                                  server.sink_pub_addr, timeout_ms=120000)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    dirs = [os.path.dirname(a[len("ipc://"):])
            for a in (server.frontend_addr, server.sink_pub_addr)]
    yield server, client
    client.close()
    server.stop()
    assert not any(os.path.exists(d) for d in dirs)
    assert not any(p.is_alive() for p in server._workers + server._procs)


def test_round_trip_matches_reference_generate(server_and_client,
                                               reference):
    _, client = server_and_client
    for job, want in zip(JOBS, reference["tokens"]):
        result = client.caption(job)
        assert set(result) == {"tokens"}
        assert result["tokens"].shape == (job["image"].shape[0],
                                          TOY_MAX_LEN + 1)
        np.testing.assert_array_equal(result["tokens"], want)


def test_multiple_jobs_in_order(server_and_client, reference):
    _, client = server_and_client
    r1 = client.caption(JOBS[1])
    r2 = client.caption(JOBS[1])
    np.testing.assert_array_equal(r1["tokens"], r2["tokens"])
    np.testing.assert_array_equal(r1["tokens"], reference["tokens"][1])


def test_caption_stream_pipelined_in_order(server_and_client, reference):
    """Results come back in submission order (the worker's ingest
    thread stages job N+1 while job N runs)."""
    _, client = server_and_client
    order = [0, 3, 1, 2, 0, 3]
    results = list(client.caption_stream((JOBS[i] for i in order),
                                         window=3))
    assert len(results) == len(order)
    for i, r in zip(order, results):
        np.testing.assert_array_equal(r["tokens"], reference["tokens"][i])


def test_caption_stream_error_raises(server_and_client):
    _, client = server_and_client
    jobs = [JOBS[0], {"image": np.zeros((1, 2), np.float32)}]
    with pytest.raises(RuntimeError):
        list(client.caption_stream(iter(jobs), window=2))
    # the stream error must not wedge the worker for later jobs
    assert "tokens" in client.caption(JOBS[0])


def test_worker_error_propagates(server_and_client, reference):
    _, client = server_and_client
    bad = {"image": np.zeros((1, 2), np.float32)}  # malformed job
    with pytest.raises(RuntimeError, match="KeyError"):
        client.caption(bad)
    with pytest.raises(RuntimeError, match="max_len"):
        client.caption(dict(JOBS[0], max_len=np.array([3])))
    with pytest.raises(RuntimeError, match="rng_seed"):
        client.caption(dict(JOBS[0], rng_seed=7))
    np.testing.assert_array_equal(client.caption(JOBS[0])["tokens"],
                                  reference["tokens"][0])


def test_worker_survives_short_multipart(server_and_client):
    """A malformed 1-frame message must not kill the ingest thread
    (the liveness monitor cannot see a wedged-but-alive worker)."""
    server, client = server_and_client
    s = _connected(transport.PUSH, server.frontend_addr)
    s.send_multipart([b"junk-single-frame"])
    s.close()
    assert "tokens" in client.caption(JOBS[0])   # worker still serves


def test_worker_stats_rpc(server_and_client):
    """The `_stats` job RPC reports plain-worker telemetry through the
    normal job routing; on the CPU no kernel is launched."""
    _, client = server_and_client
    client.caption(JOBS[0])
    stats = client.stats()
    assert set(stats) == {"mode", "worker_id", "jobs_served", "uptime_s",
                          "kernel_launches"}
    assert stats["mode"] == "plain" and stats["worker_id"] == 0
    n = stats["jobs_served"]
    assert n >= 1 and stats["uptime_s"] >= 0
    assert stats["kernel_launches"] == dict.fromkeys(
        ("band_topk_lse", "decode_cross_attention", "decode_conv_block",
         "decode_ffn_block", "band_topk_lse_int8",
         "decode_cross_attention_int8", "band_topk_lse_generic",
         "decode_cross_attention_generic", "decode_conv_block_generic",
         "decode_ffn_block_generic", "band_topk_lse_int8_generic",
         "decode_cross_attention_int8_generic"), 0)
    client.caption(JOBS[0])
    assert client.stats()["jobs_served"] == n + 1


def test_http_proxy(server_and_client, reference):
    _, client = server_and_client
    httpd, port = http.serve_http(client, server_info={"model": "tiny"})
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/status") as r:
            status = json.loads(r.read())
        assert status == {"status": "ok", "model": "tiny"}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/status/worker") as r:
            wstat = json.loads(r.read())
        assert wstat["status"] == "ok" and wstat["mode"] == "plain"
        assert "jobs_served" in wstat
        payload = {k: {"data": v.tolist(), "dtype": str(v.dtype)}
                   for k, v in JOBS[2].items()}
        for extra in ({}, {"_stats": True}):   # `_stats` is stripped
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/encode",
                data=json.dumps(dict(payload, **extra)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                result = json.loads(r.read())
            assert set(result) == {"tokens"}
            assert result["tokens"] == reference["tokens"][2].tolist()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_terminate_command_is_not_a_job(server_and_client):
    """ServerCmd.terminate is the relay's control word; the sink has
    its own. Here only its constant is held to the reference's (sending
    it would stop the module's server)."""
    from news_image_caption_tpu.serving.base import ServerCmd as JaxCmd
    assert (ServerCmd.terminate, ServerCmd.show_config,
            ServerCmd.new_job) == (JaxCmd.terminate, JaxCmd.show_config,
                                   JaxCmd.new_job)


def test_worker_respawn_after_crash(server_and_client, reference):
    """When a worker process dies, the monitor respawns it and later jobs
    succeed. Last of the server's tests: it replaces the worker."""
    server, client = server_and_client
    dead = server._workers[0]
    dead.kill()
    deadline = time.monotonic() + 60
    while server.respawn_count == 0 and time.monotonic() < deadline:
        time.sleep(0.2)
    assert server.respawn_count == 1 and not dead.is_alive()
    assert server._workers[0] is not dead
    out = client.caption(JOBS[0])
    np.testing.assert_array_equal(out["tokens"], reference["tokens"][0])
    assert client.stats()["jobs_served"] == 1   # a fresh worker


# -- the serve command --------------------------------------------------------

def _children(pid):
    """Pids of the live processes that pid started with multiprocessing's
    spawn (the sink and the workers; not its resource tracker)."""
    out = []
    for stat in glob.glob("/proc/[0-9]*/stat"):
        child = int(stat.split("/")[2])
        try:
            with open(stat) as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{child}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if (int(fields[1]) == pid and fields[0] != "Z"
                and b"spawn_main" in cmdline):
            out.append(child)
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _serve(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "news_image_caption_tpu_torch.cli", "serve",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)


def test_cli_serve_end_to_end_then_sigterm(reference):
    """`serve --task toy --platform cpu --http-port 0` starts the whole
    stack; a job through the HTTP proxy returns the reference's tokens;
    SIGTERM ends it with rc 0 and no worker left."""
    proc = _serve("--task", "toy", "--platform", "cpu", "--http-port", "0",
                  "--params", reference["params_path"])
    try:
        info = json.loads(proc.stdout.readline())
        assert info["task"] == "toy" and info["n_workers"] == 1
        assert info["frontend_addr"].startswith("ipc://")
        assert info["sink_pub_addr"].startswith("ipc://")
        port = json.loads(proc.stdout.readline())["http_port"]
        payload = {k: {"data": v.tolist(), "dtype": str(v.dtype)}
                   for k, v in JOBS[1].items()}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/encode",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            result = json.loads(r.read())
        assert result["tokens"] == reference["tokens"][1].tolist()
        children = _children(proc.pid)
        assert len(children) == 2          # the sink and the worker
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not any(_alive(p) for p in children)
        for key in ("frontend_addr", "sink_pub_addr"):
            assert not os.path.exists(
                os.path.dirname(info[key][len("ipc://"):]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_cli_serve_sigterm_during_startup():
    """SIGTERM while the worker is still starting: graceful exit 0, no
    orphaned children."""
    proc = _serve("--task", "toy", "--platform", "cpu")
    try:
        info = json.loads(proc.stdout.readline())
        assert "frontend_addr" in info
        children = _children(proc.pid)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert children and not any(_alive(p) for p in children)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("args, error, match", [
    (["--speculative-k", "2"], RuntimeError, "no CUDA device"),
    (["--continuous-slots", "2"], RuntimeError, "no CUDA device"),
    (["--continuous-slots", "2", "--continuous-beam"], RuntimeError,
     "no CUDA device"),
    (["--sampling-topk", "2", "--continuous-slots", "2"],
     RuntimeError, "no CUDA device"),
    (["--quantize-kv"], RuntimeError, "no CUDA device"),
    (["--task", "toy"], RuntimeError, "no CUDA device"),
    (["--task", "toy", "--platform", "cuda"], RuntimeError,
     "no CUDA device"),
    ([], RuntimeError, "no CUDA device"),
    (["--platform", "cuda"], RuntimeError, "no CUDA device"),
])
def test_cli_serve_raises_before_spawning(args, error, match,
                                          monkeypatch):
    """Every switch the port lacks raises naming its item, before any
    process is spawned; without `--platform cpu` serve needs the card,
    and the test runs where there is none (it checks so first)."""
    assert not torch.cuda.is_available()
    monkeypatch.setattr(CaptionServer, "start", _no_start)
    with pytest.raises(error, match=match):
        cli.main(["serve", *args])


def _no_start(self):
    raise AssertionError("the server was started")


@pytest.mark.parametrize("args", [["--quantize-kv"], ["--quantize-head"],
                                  ["--quantize-kv", "--quantize-head"]])
def test_cli_serve_quantized_routes_reach_the_worker(args, narrow_flagship,
                                                     monkeypatch):
    """`serve --quantize-kv` / `--quantize-head` hand the switches to the
    flagship builder of every worker: the worker's builder, called as
    the worker calls it, serves through the int8 routes (the flagship at
    the toy's widths, on the CPU; no process is spawned)."""
    workers = []

    def no_spawn(self):
        workers.append(self.worker_factory(worker_id=0, receive_addr="",
                                           sink_addr=""))

    monkeypatch.setattr(CaptionServer, "start", no_spawn)
    assert cli.main(["serve", "--platform", "cpu", "--max-len", "6",
                     "--exit-after-ready", *args]) == 0
    (w,) = workers
    predict = w.model_builder(device=w._device())
    _quantized_route_runs(predict, narrow_flagship, "--quantize-kv" in args,
                          "--quantize-head" in args)


@pytest.mark.parametrize("args", [
    ["--sampling-topk", "2"],
    ["--continuous-beam"],
    ["--sampling-topk", "2", "--continuous-slots", "2",
     "--continuous-beam"],
    ["--sampling-topk", "2", "--continuous-slots", "2", "--speculative-k",
     "4"],
])
def test_cli_serve_argument_errors_exit_2(args, monkeypatch, capsys):
    """The reference's argument errors: exit code 2 and a message."""
    monkeypatch.setattr(CaptionServer, "start", _no_start)
    assert cli.main(["serve", "--task", "toy", "--platform", "cpu",
                     *args]) == 2
    assert capsys.readouterr().err.startswith("error: --")


def test_port_imports_no_zmq_jax_or_reference():
    """No module of the port imports zmq, jax, flax or the reference
    package, checked on the source of every module (the import test in
    test_torch_structure.py checks the loaded modules)."""
    banned = ("zmq", "jax", "jaxlib", "flax", "news_image_caption_tpu")
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad
    assert (PORT / "serving" / "transport.py").exists()
