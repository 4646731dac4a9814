"""One run of one cell.

Set-up: the configuration's weights drawn from the seed on the device, the
port's ``ServingEngine`` deployed on a ``Triggerflow`` under
``KedaAutoscaler`` (as ``launch/serve.py`` runs it), and one warm-up batch
at the mix's largest shapes through the whole path.  Then the window: the
mix's client publishes requests through ``ServingEngine.submit``; the
batcher trigger fires ``serve.batch``, which runs ``Model.prefill`` and
``Model.decode`` and publishes one ``serve|done|<id>`` event a request.
The client receives a done event when it is published (a wrapper on the
event store's ``publish``, outside the port).

A request is due at its schedule's time (open loop) or when its caller's
previous reply arrived (closed loop); the requests due inside the window
are the ones counted.  After the window the client goes on sending until
every counted request is done (at most ``DRAIN_S`` past the close), so no
counted request waits on a batch that never fills.

The traced run (``trace=True``) also records, from outside the port,
spans around ``generate_batch``, ``Model.prefill`` and ``Model.decode``
(each ended by ``torch.cuda.synchronize()``) and profiles a slice of the
window (``trace_batches`` whole batches starting after the first third of
it) with ``torch.profiler``; the profiled batches are left out of the
spans' sums, since the profiler slows them.

After the run the program's state is freed and ``check`` compares what it
served with the plain reference.
"""
from __future__ import annotations

import gc
import math
import queue
import statistics
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, trace as trace_mod, weights as weights_mod
from .traffic import Traffic

DRAIN_S = 60.0
WORKFLOW = "serve"
DONE = "serve|done|"


class Request:
    __slots__ = ("id", "index", "prompt_len", "caller", "due", "sent", "done", "tokens")

    def __init__(self, rid, index, prompt_len, caller, due):
        self.id, self.index, self.prompt_len, self.caller = rid, index, prompt_len, caller
        self.due, self.sent, self.done, self.tokens = due, None, None, None


class Batch:
    __slots__ = ("index", "ids", "S", "t0", "t1", "profiled")

    def __init__(self, index, ids, S, t0):
        self.index, self.ids, self.S, self.t0 = index, ids, S, t0
        self.t1, self.profiled = None, False


class Run:
    """What a run recorded; the per-layer metrics' readers read it.

    ``requests`` by id, ``batches`` in the order they started,
    ``prefills`` [(t0, t1, B, S, real prompt tokens, batch index)] and
    ``decodes`` [(t0, t1, B, pos, batch index)] (traced runs only), the
    window's bounds ``t_open`` and ``t_close`` (``time.perf_counter``), and
    ``trace``, the profiled slice reduced by ``benchlib.trace`` (or None)."""

    def __init__(self, conf, mix, seconds):
        self.conf, self.mix, self.seconds = conf, mix, seconds
        self.requests: Dict[str, Request] = {}
        self.batches: List[Batch] = []
        self.prefills: List[tuple] = []
        self.decodes: List[tuple] = []
        self.t_open = self.t_close = None
        self.trace = None
        self.profiled_prefills: List[tuple] = []

    def counted(self) -> List[Request]:
        return [r for r in self.requests.values()
                if r.due is not None and self.t_open <= r.due < self.t_close]

    def window_batches(self) -> List[Batch]:
        """Batches that started inside the window and were not profiled."""
        return [b for b in self.batches
                if self.t_open <= b.t0 < self.t_close and not b.profiled and b.t1]

    def _in_window(self, batch_index: int) -> bool:
        b = self.batches[batch_index]
        return self.t_open <= b.t0 < self.t_close and not b.profiled

    def window_prefills(self):
        return [p for p in self.prefills if self._in_window(p[5])]

    def window_decodes(self):
        return [d for d in self.decodes if self._in_window(d[4])]


def make_engine(model, tf, mix):
    """The port's ``ServingEngine`` serving ``model`` (the engine builds its
    own ``Model`` from seed 0; the benchmark's weights take its place)."""
    from repro_torch.serving import engine as E

    real = E.Model
    E.Model = lambda cfg, device=None, seed=0: model
    try:
        eng = E.ServingEngine(model.cfg, tf, WORKFLOW, max_batch=mix["max_batch"],
                              max_new_tokens=mix["max_new_tokens"], max_len=mix["max_len"])
    finally:
        E.Model = real
    return eng


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """The wrappers the harness puts around the port's calls, from outside:
    the event store's ``publish`` (the client's receipt of done events),
    ``generate_batch`` (batch composition; spans and the profiler in traced
    runs), and ``Model.prefill`` / ``Model.decode`` (traced runs)."""

    def __init__(self, run: Run, eng, tf, device, trace: bool, on_done: Callable):
        self.device, self.trace = device, trace
        self.on_done = on_done
        self.current = None
        self.prof = None
        self.profiled = 0
        self.sessions = 0
        self.trace_after = math.inf
        self.trace_batches = run.mix["trace_batches"]
        self.profile = None
        self.stop_s = None
        store = tf.event_store
        real_publish = store.publish

        def publish(workflow, event):
            real_publish(workflow, event)
            if event.subject.startswith(DONE):
                self.on_done(event.subject[len(DONE):], event.data["result"]["tokens"],
                             time.perf_counter())

        store.publish = publish
        real_gen = eng.generate_batch

        def generate_batch(requests):
            b = Batch(len(run.batches), [r["id"] for r in requests],
                      max(len(r["prompt"]) for r in requests), time.perf_counter())
            run.batches.append(b)
            self.current = b
            try:
                if not self.trace:
                    out = real_gen(requests)
                else:
                    self._maybe_start(b)
                    with torch.profiler.record_function("bench.batch"):
                        out = real_gen(requests)
                    self._maybe_stop(b)
            finally:
                b.t1 = time.perf_counter()
            return out

        eng.generate_batch = generate_batch
        if trace:
            model = eng.model
            real_prefill, real_decode = model.prefill, model.decode

            def prefill(batch, max_len=None):
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench.prefill"):
                    out = real_prefill(batch, max_len=max_len)
                    _sync(device)
                tokens = batch["tokens"]
                b = self.current
                real = sum(run.requests[i].prompt_len for i in b.ids if i in run.requests)
                rec = (t0, time.perf_counter(), tokens.shape[0], tokens.shape[1], real, b.index)
                run.prefills.append(rec)
                return out

            def decode(cache, batch):
                t0 = time.perf_counter()
                pos = cache["pos"]
                with torch.profiler.record_function("bench.decode"):
                    out = real_decode(cache, batch)
                    _sync(device)
                run.decodes.append((t0, time.perf_counter(), batch["tokens"].shape[0], pos,
                                    self.current.index))
                return out

            model.prefill, model.decode = prefill, decode

    def _maybe_start(self, b: Batch):
        if self.prof is None and self.profiled == 0 and b.t0 >= self.trace_after \
                and self.sessions < 2:
            from torch.profiler import ProfilerActivity, profile

            self.sessions += 1
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        if self.prof is not None:
            b.profiled = True
            self.profiled += 1

    def _maybe_stop(self, b: Batch):
        if self.prof is None or self.profiled < self.trace_batches:
            return
        from torch.autograd import DeviceType

        _sync(self.device)
        t0 = time.perf_counter()
        self.prof.stop()
        t1 = time.perf_counter()
        # a profiling session now and then sees no device activity: then
        # profile the next batches instead (the profile itself is read
        # after the window)
        seen = self.device.type != "cuda" or any(
            e.device_type() == DeviceType.CUDA
            for e in self.prof.profiler.kineto_results.events())
        self.stop_s = (t1 - t0, time.perf_counter() - t1)
        if seen:
            self.profile = self.prof
            self.profiled = self.trace_batches + 1          # done
        else:
            self.profiled = 0
        self.prof = None


def _warm_up(eng, mix, traffic: Traffic, received: dict):
    """One batch of ``max_batch`` prompts at the mix's longest through the
    whole path (trigger, prefill, every decode step), then wait for it."""
    n, L = mix["max_batch"], mix["prompt"]["max"]
    rng = np.random.default_rng([traffic.key, 4])
    ids = [f"warm-{i}" for i in range(n)]
    for rid in ids:
        eng.submit(rid, rng.integers(1, traffic.vocab, L).tolist())
    t0 = time.perf_counter()
    while not all(rid in received for rid in ids):
        if time.perf_counter() - t0 > 600:
            raise RuntimeError("the warm-up batch was not served within 600 s")
        time.sleep(0.005)


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, conf: Optional[dict] = None, mix: Optional[dict] = None,
             on_engine: Optional[Callable] = None, settings: Optional[dict] = None,
             control: bool = False, keep: Optional[dict] = None) -> dict:
    """One run → the result (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` where traced, ``compared``).
    ``settings`` default to the cell's file (``Spec.settings``);
    ``on_engine(eng)`` may break the timed path (the tests' faults);
    ``control`` also reads the fp8 control on the sample (``bench/control.py``);
    ``keep``, a dict, receives the ``Run`` under ``"run"``."""
    from repro_torch.core import KedaAutoscaler, Triggerflow
    from repro_torch.serving import engine as E

    device = torch.device(device)
    cell = spec.cell(cell_name)
    conf = spec.bind(conf or spec.config(cell["config"]))
    mix = mix or spec.mix(cell["traffic"])
    settings = settings if settings is not None else spec.settings(cell_name)
    run = Run(conf, mix, seconds)
    if keep is not None:
        keep["run"] = run
    traffic = Traffic(mix, seed, conf["vocab_size"])

    model, weights = weights_mod.build(conf, seed, device)
    before = weights_mod.fingerprint(weights)
    tf = Triggerflow(inline_functions=True, device=str(device),
                     commit_policy=settings.get("commit_policy", "on_fire"))
    eng = make_engine(model, tf, mix)
    eng.deploy()
    received: Dict[str, float] = {}
    sends: "queue.Queue" = queue.Queue()
    lock = threading.Lock()

    def on_done(rid, tokens, t):
        with lock:
            received[rid] = t
            r = run.requests.get(rid)
            if r is not None:
                r.done, r.tokens = t, tokens
                if r.caller is not None:
                    sends.put((r.caller, t))

    rec = Recorder(run, eng, tf, device, trace, on_done)
    if on_engine is not None:
        on_engine(eng)
    scaler = KedaAutoscaler(tf, **mix["autoscaler"]).start()
    try:
        _warm_up(eng, mix, traffic, received)
        if trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.ones(8, device=device).sum().item()
        _sync(device)
        run.t_open = time.perf_counter()
        run.t_close = run.t_open + seconds
        rec.trace_after = run.t_open + seconds / 3
        setup_s = run.t_open - t_process
        lateness = _client(run, eng, mix, traffic, sends)
    finally:
        scaler.stop()
        tf.shutdown()
        t0 = time.perf_counter()
        for th in list(tf._threads.values()):
            th.join(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
    t_end = time.perf_counter()

    counted = run.counted()
    done_in_window = [r for r in run.requests.values()
                      if r.done is not None and run.t_open <= r.done <= run.t_close]
    tokens_per_s = sum(r.prompt_len + len(r.tokens) for r in done_in_window) / seconds
    lat = [((r.done if r.done is not None else t_end) - r.due) * 1e3 for r in counted]
    # an end-to-end metric's name is its quantity, then ".<traffic>" where
    # cells of different traffic hold it to different bounds
    measured = {"tokens_per_s": tokens_per_s,
                "request_p95_ms": float(np.percentile(lat, 95)) if lat else None,
                "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_trace = time.perf_counter()
    if rec.profile is not None:
        run.trace = trace_mod.reduce(rec.profile.events())
        run.profiled_prefills = [p for p in run.prefills
                                 if run.batches[p[5]].profiled]
    t_trace = time.perf_counter() - t_trace
    rec.profile = None

    result = {"attempted": len(counted)}
    if trace:
        metrics = {}
        for m in spec.per_layer(cell_name):
            value = spec.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": measured[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell_name)
                   if measured.get(m["name"].split(".")[0]) is not None}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_us"] / 1e6
        dev["window_s"] = run.trace["window_us"] / 1e6
        result["breakdown"] = {
            "device_ops": [[n[:120], us / 1e6] for n, us in sorted(
                run.trace["by_name"].items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in sorted(
                run.trace["gaps"].items(), key=lambda kv: -kv[1])[:10]]}
    result["device"] = dev

    stop_s = rec.stop_s
    # free the program's state; the benchmark's weights stay for the reference
    E._ENGINES.pop(WORKFLOW, None)
    del eng, model, rec, tf, scaler
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    changed = int(not torch.equal(before, weights_mod.fingerprint(weights)))
    verdict = check.judge(run, weights, conf, mix, traffic, settings["limits"], changed,
                          control, device)
    result.update(correct=verdict["correct"], failed=verdict["failed"])
    spans = [b.t1 - b.t0 for b in run.window_batches()]
    result["info"] = {"lateness_ms_p99": lateness, "batches": len(spans),
                      "batch_s_median": statistics.median(spans) if spans else None,
                      "reference_s": verdict["reference_s"], "trace_read_s": t_trace,
                      "profiler_stop_s": stop_s, **verdict["info"]}
    result["compared"] = verdict["compared"]
    return result


def _client(run: Run, eng, mix, traffic: Traffic, sends: "queue.Queue") -> float:
    """Send the mix's requests until every counted one is done (or DRAIN_S
    past the close) → the 99th percentile of how late the client sent, ms."""
    late = []
    i = 0

    def send(caller, due):
        nonlocal i
        rid = f"r{i}"
        prompt = traffic.prompt(i)
        r = Request(rid, i, len(prompt), caller, due)
        run.requests[rid] = r
        i += 1
        r.sent = time.perf_counter()
        late.append(r.sent - due)
        eng.submit(rid, prompt)

    def finished(now) -> bool:
        if now < run.t_close:
            return False
        if now > run.t_close + DRAIN_S:
            return True
        return all(r.done is not None for r in run.counted())

    if mix["loop"] == "open":
        due = run.t_open + traffic.gap(0)
        while True:
            now = time.perf_counter()
            if finished(now):
                break
            if due > now:
                time.sleep(min(due - now, 0.02))
                continue
            send(None, due)
            due += traffic.gap(i)
    else:
        for c in range(mix["callers"]):
            sends.put((c, run.t_open))
        while True:
            try:
                caller, due = sends.get(timeout=0.02)
            except queue.Empty:
                if finished(time.perf_counter()):
                    break
                continue
            if finished(time.perf_counter()):
                break
            send(caller, due)
    return float(np.percentile(late, 99) * 1e3) if late else 0.0
