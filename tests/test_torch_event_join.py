"""The port's event_join (K1) against the JAX package's.

On the CPU the port's wrapper runs its plain torch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_kernels.py does.  Counts
are integers, so every comparison is exact.  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.event_join import dispatch as ref_dispatch
from repro.kernels.event_join.ops import event_join as jax_event_join
from repro.kernels.event_join.ref import join_counts_ref
from repro_torch.kernels.event_join import dispatch, ops


def _case(n_triggers, n_events, seed, low=0, high=None):
    rng = np.random.default_rng(seed)
    high = n_triggers if high is None else high
    events = rng.integers(low, high, n_events).astype(np.int32)
    counts = rng.integers(0, 5, n_triggers).astype(np.int32)
    expected = rng.integers(1, 30, n_triggers).astype(np.int32)
    return events, counts, expected


def _port(events, counts, expected):
    nc, fired = ops.event_join(*(torch.from_numpy(a) for a in (events, counts, expected)))
    return nc.numpy(), fired.numpy()


# the sweep of tests/test_kernels.py's property test: (triggers, events, block)
SWEEP = [(1, 1, 16), (7, 13, 16), (50, 1000, 512), (33, 257, 64), (2, 999, 128),
         (20, 500, 300), (1, 1000, 16), (50, 1, 512)]


@pytest.mark.parametrize("n_triggers,n_events,block", SWEEP)
def test_event_join_matches_pallas_and_ref(n_triggers, n_events, block):
    events, counts, expected = _case(n_triggers, n_events, n_triggers * 1000 + n_events)
    want_nc, want_f = jax_event_join(jnp.asarray(events), jnp.asarray(counts),
                                     jnp.asarray(expected), block_events=block,
                                     interpret=True)
    ref_nc, ref_f = join_counts_ref(jnp.asarray(events), jnp.asarray(counts),
                                    jnp.asarray(expected))
    nc, fired = _port(events, counts, expected)
    assert nc.dtype == np.int32 and fired.dtype == np.int32
    np.testing.assert_array_equal(nc, np.asarray(want_nc))
    np.testing.assert_array_equal(fired, np.asarray(want_f))
    np.testing.assert_array_equal(nc, np.asarray(ref_nc))
    np.testing.assert_array_equal(fired, np.asarray(ref_f))
    # the segments entry the worker calls, on the torch backend
    lens = np.bincount(events, minlength=n_triggers)
    seg_nc, seg_f = dispatch.join_counts_segments(lens, counts, expected,
                                                  dispatch.resolve_join_backend("torch")[1])
    np.testing.assert_array_equal(seg_nc, np.asarray(ref_nc))
    np.testing.assert_array_equal(seg_f, np.asarray(ref_f))


def test_event_join_padding_ignored():
    events = np.asarray([0, 1, -1, -1, 0], np.int32)
    counts = np.zeros(2, np.int32)
    expected = np.asarray([2, 1], np.int32)
    want_nc, want_f = jax_event_join(jnp.asarray(events), jnp.asarray(counts),
                                     jnp.asarray(expected), block_events=4,
                                     interpret=True)
    nc, fired = _port(events, counts, expected)
    assert nc.tolist() == [2, 1] == np.asarray(want_nc).tolist()
    assert fired.tolist() == [1, 1] == np.asarray(want_f).tolist()


@pytest.mark.parametrize("n_triggers,n_events", [(5, 0), (5, 200), (100, 4096)])
def test_event_join_out_of_range_ids_and_empty(n_triggers, n_events):
    """Ids >= T and -1 padding are dropped; N=0 gives (counts, counts >=
    expected).  Held against join_counts_ref only: the Pallas wrapper divides
    by zero at N=0 and the reference's numpy backend fails on ids >= T."""
    events, counts, expected = _case(n_triggers, n_events, 7, low=-1,
                                     high=2 * n_triggers)
    ref_nc, ref_f = join_counts_ref(jnp.asarray(events), jnp.asarray(counts),
                                    jnp.asarray(expected))
    for nc, fired in (_port(events, counts, expected),
                      dispatch.resolve_join_backend("torch")[1](events, counts, expected)):
        np.testing.assert_array_equal(nc, np.asarray(ref_nc))
        np.testing.assert_array_equal(fired, np.asarray(ref_f))
    if n_events == 0:
        np.testing.assert_array_equal(nc, counts)


def test_event_join_rejects_bad_inputs():
    ev = torch.zeros(4, dtype=torch.int64)
    c = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.event_join(ev, c, c)
    with pytest.raises(ValueError, match="differ"):
        ops.event_join(ev.int(), c, torch.zeros(2, dtype=torch.int32))


def test_backends_resolve_and_agree():
    """The port's one plain CPU backend, ``torch``, against the reference's
    ``numpy`` backend and ``join_counts_ref``; exact."""
    events, counts, expected = _case(12, 300, 3)
    ref_nc, ref_f = (np.asarray(a) for a in join_counts_ref(
        jnp.asarray(events), jnp.asarray(counts), jnp.asarray(expected)))
    np_nc, np_f = ref_dispatch.resolve_join_backend("numpy")[1](events, counts, expected)
    resolved, fn = dispatch.resolve_join_backend("torch")
    assert resolved == "torch"
    nc, fired = fn(events, counts, expected)
    for want_nc, want_f in ((ref_nc, ref_f), (np_nc, np_f)):
        np.testing.assert_array_equal(nc, want_nc)
        np.testing.assert_array_equal(fired, want_f)
    assert dispatch.resolve_join_backend("off") == ("off", None)
    for name in ("jax", "pallas", "numpy"):
        with pytest.raises(ValueError, match="JAX package"):
            dispatch.resolve_join_backend(name)
    with pytest.raises(ValueError, match="unknown"):
        dispatch.resolve_join_backend("triton")
    # the worker alone resolves auto and bare cuda, from its device
    for name in ("auto", None, "cuda"):
        with pytest.raises(ValueError, match="worker"):
            dispatch.resolve_join_backend(name)


def test_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda:0", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA"):
            dispatch.resolve_join_backend(name)


def test_cuda_backend_is_bound_to_its_device(monkeypatch):
    """``cuda:<index>`` binds that device when the backend is built; nothing
    reads the current device, and two devices get two backends."""
    def no_current_device():
        raise AssertionError("the join backend read the current device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", no_current_device)
    (n1, f1), (n0, f0) = (dispatch.resolve_join_backend(f"cuda:{i}") for i in (1, 0))
    assert (n1, n0) == ("cuda:1", "cuda:0")
    assert f1.device == torch.device("cuda", 1) and f0.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="index"):
        dispatch.CudaJoin(torch.device("cuda"))
