"""The reference's int8 delta-compression cases against the port's copy
(``repro_torch.distributed.compression``, a verbatim copy under the drift
guard of ``test_torch_runtime.py``), the federated-learning case on the
port's Triggerflow on the CPU.  Tolerances are the reference's."""
import numpy as np
from _hypothesis_compat import given, settings, st

from repro_torch.distributed.compression import (apply_delta, compress_delta,
                                           compressed_bytes, dequantize_int8,
                                           quantize_int8)


@given(st.integers(0, 1000), st.floats(0.01, 100.0))
@settings(max_examples=30, deadline=None)
def test_quantize_bounded_error(seed, scale):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=scale, size=64).astype(np.float32)
    packed = quantize_int8(x)
    err = np.abs(dequantize_int8(packed) - x).max()
    assert err <= packed["scale"] * 0.5 + 1e-7  # round-to-nearest bound
    # →4× asymptotically; the 8-byte scale header dominates tiny tensors
    assert compressed_bytes(packed) < x.nbytes / 3


def test_stochastic_rounding_unbiased():
    rng = np.random.default_rng(0)
    x = np.full(20_000, 0.3, np.float32)  # exactly between quant levels
    packed = quantize_int8(x, rng=rng)
    mean = dequantize_int8(packed).mean()
    assert abs(mean - 0.3) < 0.01


def test_delta_roundtrip():
    rng = np.random.default_rng(1)
    base = rng.normal(size=128)
    new = base + rng.normal(scale=0.01, size=128)  # small training delta
    packed = compress_delta(new, base)
    rec = apply_delta(base, packed)
    assert np.abs(rec - new).max() <= np.abs(new - base).max() / 254 + 1e-7


def test_fl_with_compressed_deltas():
    """End-to-end: FL clients ship int8 deltas; training still converges."""
    from repro_torch.core import Triggerflow
    from repro_torch.core.fedlearn import FederatedLearningOrchestrator, ObjectStore

    rng = np.random.default_rng(2)
    w_true = rng.normal(size=8)
    shards = []
    for _ in range(6):
        X = rng.normal(size=(120, 8))
        shards.append((X, (X @ w_true > 0).astype(float)))
    store = ObjectStore()
    wire = {"bytes": 0, "raw": 0}

    def client(args):
        base = np.asarray(store.get(args["model"]))
        X, y = shards[args["client"]]
        w = base.copy()
        for _ in range(4):
            p = 1 / (1 + np.exp(-(X @ w)))
            w -= 0.5 * X.T @ (p - y) / len(y)
        packed = compress_delta(w, base)
        wire["bytes"] += compressed_bytes(packed)
        wire["raw"] += w.astype(np.float32).nbytes
        return {"round": args["round"],
                "result": store.put(f"d/{args['round']}/{args['client']}", packed)}

    def aggregate(keys, st_):
        base_key = f"model/{rounds_seen[0]}"
        base = np.asarray(st_.get(base_key))
        ws = [apply_delta(base, st_.get(k)) for k in keys]
        rounds_seen[0] += 1
        return np.mean(ws, axis=0).tolist()

    rounds_seen = [0]
    tf = Triggerflow(inline_functions=True, device="cpu")
    fl = FederatedLearningOrchestrator(tf, "flc", client, aggregate,
                                       n_clients=6, rounds=3, threshold=1.0,
                                       object_store=store)
    fl.deploy()
    out = fl.start(init_model=np.zeros(8).tolist(), timeout=60)
    assert out["status"] == "succeeded"
    w = np.asarray(store.get(out["result"]["model"]))
    Xt = np.random.default_rng(3).normal(size=(500, 8))
    acc = (((Xt @ w) > 0) == ((Xt @ w_true) > 0)).mean()
    assert acc > 0.9
    # 8-dim toy deltas: 8B payload + 8B scale = exactly 2x; real models →4x
    assert wire["bytes"] < wire["raw"] / 1.9
