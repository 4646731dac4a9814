"""The port's event_join (K1) against the JAX package's.

On the CPU the port's wrapper runs its plain torch version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_kernels.py does.  Counts
are integers, so every comparison is exact.  The join backend's host path
(``dispatch.CudaJoin``: the inputs packed into one buffer, the [2, T] output
unpacked into two fresh arrays, buffers grown by doubling) runs here with the
plain version in place of the copy, the launch and the copy back.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py
and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.event_join import dispatch as ref_dispatch
from repro.kernels.event_join.event_join import event_join_counts
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


class _HostPath(dispatch.CudaJoin):
    """The join backend on the CPU: ``CudaJoin`` itself, which reserves,
    grows, packs and unpacks its buffers as on the card, with its four card
    methods replaced: no stream, host tensors for the pinned buffers and the
    scratch, and for the launch the plain version on the packed input,
    written into the [2, T] output after checking that the buffers hold what
    ``ops.roundtrip`` demands of them."""

    def __init__(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            super().__init__(torch.device("cuda", 0))

    def _open(self):
        self._stream, self._blocks = "stream", 1

    def _pinned(self, ints):
        return torch.zeros(ints, dtype=torch.int32)

    def _zeroed_scratch(self, ints):
        return torch.zeros(ints, dtype=torch.int32)

    def _launch(self, n, T):
        assert self._host_in.numel() >= n + 2 * T and self._host_out.numel() >= 2 * T
        assert self._scratch.numel() >= 1 + T and not self._scratch.any()
        packed = self._host_in
        nc, fired = ops.event_join(packed[:n], packed[n:n + T], packed[n + T:n + 2 * T])
        self._host_out[:2 * T] = torch.cat([nc, fired])

    @property
    def host_in(self):
        return self._host_in_np

    @property
    def host_out(self):
        return self._host_out_np


def _assert_matches_jax(events, counts, expected, got):
    """``got`` against join_counts_ref and, where N > 0 (the Pallas wrapper
    divides by zero at N = 0), the Pallas kernel in interpret mode; exact."""
    args = [jnp.asarray(a) for a in (events, counts, expected)]
    wants = [join_counts_ref(*args)]
    if len(events):
        wants.append(event_join_counts(*args, interpret=True))
    for nc, fired in wants:
        for g, w in zip(got, (nc, fired)):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w))


def _runs(T, n):
    """The worker's batches: contiguous runs of one trigger row id."""
    return np.repeat(np.arange(T, dtype=np.int32), n // T)


# (name, events, T): N 0, padding only, ids at and past T, one trigger, T
# past the kernel's 49 152 shared-memory bins, and the main path's shape
HOST_CASES = [("empty", np.zeros(0, np.int32), 5),
              ("all padding", np.full(300, -1, np.int32), 7),
              ("ids past T", np.random.default_rng(1).integers(-1, 40, 500).astype(np.int32), 20),
              ("one trigger", np.random.default_rng(2).integers(-1, 3, 100).astype(np.int32), 1),
              ("past the shared bins",
               np.random.default_rng(3).integers(-1, 49_160, 200).astype(np.int32), 49_153),
              ("main path", _runs(100, 4096), 100)]


@pytest.mark.parametrize("name,events,T", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_host_path_matches_pallas_and_ref(name, events, T):
    rng = np.random.default_rng(T)
    counts = rng.integers(0, 5, T).astype(np.int32)
    expected = rng.integers(1, 60, T).astype(np.int32)
    _assert_matches_jax(events, counts, expected, _HostPath()(events, counts, expected))


def test_host_path_buffers_grow_between_calls():
    """One host path through every case of HOST_CASES in turn, its buffers
    growing and then shrinking in use: each call exact, and each call's
    arrays unchanged by the calls after it."""
    path = _HostPath()
    kept = []
    for i, (_, events, T) in enumerate(HOST_CASES + HOST_CASES[:2]):
        rng = np.random.default_rng(i)
        counts = rng.integers(0, 5, T).astype(np.int32)
        expected = rng.integers(1, 60, T).astype(np.int32)
        got = path(events, counts, expected)
        want = [np.asarray(a) for a in join_counts_ref(
            *(jnp.asarray(a) for a in (events, counts, expected)))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        kept.append((got, want))
    assert len(path.host_in) >= 49_153 * 2 + 200 and len(path.host_out) >= 2 * 49_153
    for got, want in kept:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_unpacked_arrays_are_not_views_of_the_buffer():
    """The next call overwrites the output buffer, so the arrays a call
    returns must be copies of it."""
    path = _HostPath()
    events, counts, expected = _case(10, 200, 4)
    nc, fired = path(events, counts, expected)
    first = nc.copy(), fired.copy()
    assert not np.shares_memory(nc, path.host_out) and not np.shares_memory(fired, path.host_out)
    path(np.full(200, 3, np.int32), counts + 7, expected)
    np.testing.assert_array_equal(nc, first[0])
    np.testing.assert_array_equal(fired, first[1])


def test_backend_reserves_by_doubling_and_keeps_what_suffices():
    """``CudaJoin``'s own capacity decisions: inputs n + 2T, outputs [2, T],
    scratch 1 + T; each grows only when a call needs more, at least
    doubling, and a buffer that suffices is kept (the same tensor)."""
    join = _HostPath()
    join(np.zeros(10, np.int32), np.zeros(3, np.int32), np.ones(3, np.int32))
    assert (join._cap_in, join._cap_t) == (16, 3)
    assert (join._host_in.numel(), join._host_out.numel(), join._scratch.numel()) == (16, 6, 4)
    kept = join._host_in, join._host_out, join._scratch
    join(np.zeros(12, np.int32), np.zeros(2, np.int32), np.ones(2, np.int32))
    assert all(a is b for a, b in zip(kept, (join._host_in, join._host_out, join._scratch)))
    join(np.zeros(12, np.int32), np.zeros(4, np.int32), np.ones(4, np.int32))
    assert (join._cap_in, join._cap_t) == (32, 6) and join._host_in is not kept[0]
    assert (join._host_out.numel(), join._scratch.numel()) == (12, 7)
    join(np.zeros(100, np.int32), np.zeros(4, np.int32), np.ones(4, np.int32))
    assert (join._cap_in, join._cap_t) == (108, 6) and join._scratch.numel() == 7


@pytest.mark.parametrize("capacity,need,want", [(0, 5, 5), (5, 5, 5), (5, 6, 10), (10, 100, 100),
                                                (64, 3, 64)])
def test_buffers_grow_by_doubling(capacity, need, want):
    assert dispatch.grown(capacity, need) == want


def test_pack_rejects_mismatched_rows():
    with pytest.raises(ValueError, match="differ"):
        dispatch.pack_inputs(np.zeros(16, np.int32), np.zeros(3, np.int32),
                             np.zeros(2, np.int32), np.zeros(3, np.int32))


_HYPOTHESIS_PATH = _HostPath()


@st.composite
def _join_inputs(draw):
    T = draw(st.integers(1, 48))
    n = draw(st.integers(0, 300))
    ids = st.integers(-1, T + 4)
    events = np.asarray(draw(st.lists(ids, min_size=n, max_size=n)), np.int32)
    counts = np.asarray(draw(st.lists(st.integers(0, 9), min_size=T, max_size=T)), np.int32)
    expected = np.asarray(draw(st.lists(st.integers(1, 40), min_size=T, max_size=T)), np.int32)
    return events, counts, expected


@settings(max_examples=15, deadline=None)
@given(_join_inputs())
def test_host_path_property(inputs):
    """Random N, T and ids (padding and ids >= T included) through one host
    path shared by every example, so its buffers carry over from one
    example to the next, as the backend's do between triage calls."""
    events, counts, expected = inputs
    _assert_matches_jax(events, counts, expected, _HYPOTHESIS_PATH(events, counts, expected))


def test_cuda_backend_raises_rather_than_falling_back(monkeypatch):
    """Where the card cannot be reached at the first call, the backend
    raises and keeps nothing: no CPU result comes back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    join = dispatch.CudaJoin(torch.device("cuda", 0))
    events, counts, expected = _case(4, 20, 1)
    with pytest.raises(RuntimeError):
        join(events, counts, expected)
    assert join._stream is None and join._scratch is None and join._cap_in == 0
