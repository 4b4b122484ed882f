"""The port's pool layer against the JAX package: the row kernels' plain
twins, the CPM ops the allocator needs, the allocator, the banks and the
multi-bank packer.

Held here on the CPU, on the same seeded NumPy inputs:

  * ``gather_rows_plain`` / ``scatter_rows_plain`` equal the JAX Pallas
    kernels run in interpret mode, sentinel (out-of-range) scatter ids
    included — bit for bit;
  * ``CPMArray.count`` / ``global_limit`` / ``compact`` equal the JAX
    reference backend, on the port's reference and cuda backends (the
    latter runs the kernels' plain twins on CPU rows); ops whose per-op
    kernel is still to port raise on cuda (ROADMAP Queue 2);
  * the port's ``SlotAllocator`` (reference, and cuda on CPU metadata),
    its ``OracleAllocator`` and the JAX ``SlotAllocator`` make identical
    decisions over seeded alloc / free / touch / victim / alloc_pages
    traces;
  * ``CPMBank`` gather / scatter and ``MultiBankScheduler`` flushes equal
    the JAX reference banks, and ``packed_commit`` equals JAX bit for bit
    on both port backends.

The ``cuda``-marked tests hold the CUDA kernels against their twins on
the card and skip here.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

try:                        # the reference; the GPU machine has no JAX
    import jax.numpy as jnp

    from repro.cpm import cpm_array as jcpm_array
    from repro.cpm.pool import CPMBank as JBank
    from repro.cpm.pool import MultiBankScheduler as JSched
    from repro.cpm.pool import SlotAllocator as JAlloc
    from repro.cpm.pool.scheduler import packed_commit as jpacked_commit
    from repro.kernels import cpm_kernels as JK
except ImportError:
    jnp = None

from repro_torch.cpm import cpm_array  # noqa: E402
from repro_torch.cpm.pool import (CPMBank, MultiBankScheduler,  # noqa: E402
                                  OracleAllocator, SessionTable,
                                  SlotAllocator, packed_commit)
from repro_torch.kernels import cpm_kernels as TK  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_reference(request):
    """Tests that compare with JAX skip where JAX is missing (the GPU
    machine, where only the ``cuda``-marked tests are run)."""
    if jnp is None and request.node.get_closest_marker("cuda") is None:
        pytest.skip("needs JAX, the reference package")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the H100")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bank_case(seed, r, n, k, dtype=np.int32):
    """A bank, unique in-range gather ids, and scatter ids with sentinels
    (``r`` and above) mixed in, as the pool's dirty-page write-back."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-1000, 1000, (r, n)).astype(dtype)
    gidx = rng.integers(0, r, k).astype(np.int32)
    sidx = rng.permutation(r + k)[:k].astype(np.int32)   # >= r: drop
    src = rng.integers(-1000, 1000, (k, n)).astype(dtype)
    return data, gidx, sidx, src


# ---------------------------------------------------------------------------
# the row kernels' plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

_ROW_CASES = [(24, 32, 48), (24, 32, 12), (7, 3, 5), (1, 8, 1), (48, 16, 1)]


class TestRowTwins:
    @pytest.mark.parametrize("r,n,k", _ROW_CASES)
    def test_gather_rows_plain_matches_pallas(self, r, n, k):
        data, gidx, _, _ = _bank_case(r * n + k, r, n, k)
        want = np.asarray(JK.gather_rows(jnp.asarray(data),
                                         jnp.asarray(gidx), interpret=True))
        got = TK.gather_rows_plain(_t(data), _t(gidx)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("r,n,k", _ROW_CASES)
    def test_scatter_rows_plain_matches_pallas_with_sentinels(self, r, n,
                                                              k):
        data, _, sidx, src = _bank_case(r * n + k + 1, r, n, k)
        want = np.asarray(JK.scatter_rows(jnp.asarray(data),
                                          jnp.asarray(sidx),
                                          jnp.asarray(src), interpret=True))
        got = TK.scatter_rows_plain(_t(data), _t(sidx), _t(src)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_float_rows_move_bit_for_bit(self):
        data, gidx, sidx, src = _bank_case(3, 9, 5, 4, np.float32)
        data[0, 0], src[1, 2] = np.nan, -0.0
        for got, want in (
                (TK.gather_rows_plain(_t(data), _t(gidx)),
                 JK.gather_rows(jnp.asarray(data), jnp.asarray(gidx),
                                interpret=True)),
                (TK.scatter_rows_plain(_t(data), _t(sidx), _t(src)),
                 JK.scatter_rows(jnp.asarray(data), jnp.asarray(sidx),
                                 jnp.asarray(src), interpret=True))):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))

    def test_wrappers_run_the_twins_on_cpu_tensors_uncounted(self):
        data, gidx, sidx, src = _bank_case(4, 6, 4, 3)
        ops.reset_launch_counts()
        np.testing.assert_array_equal(
            TK.gather_rows(_t(data), _t(gidx)).numpy(),
            TK.gather_rows_plain(_t(data), _t(gidx)).numpy())
        np.testing.assert_array_equal(
            TK.scatter_rows(_t(data), _t(sidx), _t(src)).numpy(),
            TK.scatter_rows_plain(_t(data), _t(sidx), _t(src)).numpy())
        counts = ops.launch_counts()
        assert counts["gather_rows"] == counts["scatter_rows"] == 0

    def test_scatter_leaves_dst_and_empty_ids(self):
        data, _, sidx, src = _bank_case(5, 6, 4, 3)
        before = data.copy()
        out = TK.scatter_rows_plain(_t(data), _t(sidx), _t(src))
        np.testing.assert_array_equal(data, before)
        empty = TK.scatter_rows_plain(_t(data), _t(sidx[:0]), _t(src[:0]))
        np.testing.assert_array_equal(empty.numpy(), data)
        assert out.shape == (6, 4)


# ---------------------------------------------------------------------------
# the CPM ops the allocator needs
# ---------------------------------------------------------------------------

class TestAllocatorOps:
    @pytest.mark.parametrize("seed", range(4))
    def test_count_limit_compact_match_jax(self, seed):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 40))
        x = rng.integers(-50, 50, (3, n)).astype(np.int32)
        ul = rng.integers(0, n + 1, 3).astype(np.int32)
        keep = rng.random((3, n)) < 0.5
        jarr = jcpm_array(x, ul, backend="reference")
        tarr = cpm_array(_t(x), _t(ul), backend="reference")
        for mode in ("min", "max"):
            np.testing.assert_array_equal(tarr.global_limit(mode).numpy(),
                                          np.asarray(jarr.global_limit(mode)))
        jc, tc = jarr.compact(keep, fill=-1), tarr.compact(_t(keep), fill=-1)
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        np.testing.assert_array_equal(tc.used_len.numpy(),
                                      np.asarray(jc.used_len))
        for i in range(3):
            row_j = jcpm_array(x[i], int(ul[i]), backend="reference")
            row_t = cpm_array(_t(x[i]), int(ul[i]), backend="reference")
            for datum, op in ((3, "lt"), (0, "ge"), (int(x[i, 0]), "eq")):
                assert int(row_t.count(datum, op)) == \
                    int(row_j.count(datum, op))

    def test_float_limit_identity_matches_jax(self):
        x = np.asarray([[1.5, -2.0, 7.0, 3.0]], np.float32)
        for ul in (0, 2, 4):
            for mode in ("min", "max"):
                got = cpm_array(_t(x), ul, backend="reference") \
                    .global_limit(mode).numpy()
                want = np.asarray(jcpm_array(x, ul, backend="reference")
                                  .global_limit(mode))
                np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("op", ["stencil", "template_match"])
    def test_cuda_backend_raises_naming_queue_2(self, op):
        """Ops whose per-op kernel is still to port raise on cuda."""
        arr = cpm_array(_t(np.arange(8, dtype=np.int32)), 5, backend="cuda")
        with pytest.raises(NotImplementedError, match="Queue 2"):
            if op == "stencil":
                arr.stencil((1.0, 2.0, 1.0))
            else:
                arr.template_match(_t(np.ones(3, np.float32)))

    @pytest.mark.parametrize("op", ["compare", "section_sum",
                                    "global_limit", "compact"])
    def test_cuda_backend_runs_the_allocator_ops(self, op):
        """The four ported ops on cuda (their twins on CPU rows) equal the
        JAX reference backend."""
        x = np.arange(8, dtype=np.int32) * 3 % 7
        tarr = cpm_array(_t(x), 5, backend="cuda")
        jarr = jcpm_array(x, 5, backend="reference")
        if op == "compact":
            keep = x % 2 == 0
            tc, jc = tarr.compact(_t(keep), fill=-1), jarr.compact(keep,
                                                                  fill=-1)
            got, want = (tc.data, tc.used_len), (jc.data, jc.used_len)
        elif op == "compare":
            got, want = (tarr.compare(3, "le"),), (jarr.compare(3, "le"),)
        elif op == "section_sum":
            got, want = (tarr.section_sum(),), (jarr.section_sum(),)
        else:
            got, want = (tarr.global_limit("min"),), \
                (jarr.global_limit("min"),)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.numpy().dtype == np.asarray(w).dtype


# ---------------------------------------------------------------------------
# allocator: port, port oracle and JAX on the same traces
# ---------------------------------------------------------------------------

class TestSlotAllocator:
    def test_alloc_free_lowest_first_and_double_free(self):
        a = SlotAllocator(4)
        assert [a.alloc() for _ in range(5)] == [0, 1, 2, 3, None]
        a.free(2)
        a.free(0)
        assert a.alloc() == 0 and a.alloc() == 2
        a.free(1)
        with pytest.raises(ValueError, match="double free"):
            a.free(1)

    def test_victim_and_used_slots(self):
        a = SlotAllocator(5)
        assert a.victim() is None
        for _ in range(4):
            a.alloc()
        a.touch(0)
        assert a.victim() == 1
        a.free(1)
        a.free(3)
        assert a.used_slots() == [0, 2] and a.victim() == 2

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    @pytest.mark.parametrize("used", [(1, 1, 1, 1), (0, 1, 1, 0),
                                      (1, 0, 0, 1), (0, 0, 0, 0)])
    def test_victim_tie_break_matches_jax(self, used, backend):
        """Forced equal ticks break to the lowest used slot in both
        packages (the Rule-6 drain orders by address)."""
        ticks = [3, 1, 1, 2]
        a, j = SlotAllocator(4, backend=backend, device="cpu"), JAlloc(4)
        a._state = torch.tensor(used, dtype=torch.int32)
        a._tick = torch.tensor(ticks, dtype=torch.int32)
        j._state = jnp.asarray(used, jnp.int32)
        j._tick = jnp.asarray(ticks, jnp.int32)
        assert a.victim() == j.victim()

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    @pytest.mark.parametrize("seed", range(6))
    def test_slot_and_page_traces_match_jax_and_oracle(self, seed, backend):
        """Seeded alloc / alloc_pages / free / touch traces (the moves of
        ``tests/test_pool.py``): every decision, page list, free count,
        page file and LRU victim agrees across the three allocators, and
        no sub-page is ever owned twice.  ``cuda`` on CPU metadata runs
        the compare / section_limit / compact kernels' plain twins."""
        rng = np.random.default_rng(seed)
        n, npg = 3, 8
        allocs = (SlotAllocator(n, n_pages=npg, backend=backend,
                                device="cpu"),
                  JAlloc(n, n_pages=npg), OracleAllocator(n, n_pages=npg))
        port, jax_a, orc = allocs
        held: set[int] = set()
        for i in range(60):
            mv, arg = int(rng.integers(0, 4)), int(rng.integers(0, 8))
            if mv == 0:
                got = [a.alloc() for a in allocs]
                assert got[0] == got[1] == got[2]
                if got[0] is not None:
                    held.add(got[0])
            elif mv == 1 and held:
                slot = sorted(held)[i % len(held)]
                k, lo = 1 + arg % 3, (arg % 2) * (npg // 2)
                got = [a.alloc_pages(slot, k, lo, lo + npg // 2)
                       for a in allocs]
                assert got[0] == got[1] == got[2]
            elif mv == 2 and held:
                slot = sorted(held)[i % len(held)]
                for a in allocs:
                    a.free(slot)
                held.discard(slot)
            elif mv == 3 and held:
                slot = sorted(held)[i % len(held)]
                for a in allocs:
                    a.touch(slot)
            owned = [p for s in held for p in orc.pages(s)]
            assert len(owned) == len(set(owned))
            for s in sorted(held):
                assert port.pages(s) == jax_a.pages(s) == orc.pages(s)
            assert (port.page_free_count() == jax_a.page_free_count()
                    == orc.page_free_count() == npg - len(owned))
            assert port.free_count() == jax_a.free_count() \
                == orc.free_count()
            assert port.used_slots() == jax_a.used_slots() \
                == orc.used_slots()
            np.testing.assert_array_equal(port.page_state_vector(),
                                          jax_a.page_state_vector())
            assert port.victim() == jax_a.victim() == orc.victim()

    def test_alloc_pages_all_or_nothing_and_owner_checks(self):
        a = SlotAllocator(2, n_pages=4)
        with pytest.raises(ValueError, match="owner"):
            a.alloc_pages(0, 1)
        s = a.alloc()
        with pytest.raises(ValueError, match="positive"):
            a.alloc_pages(s, 0)
        with pytest.raises(IndexError):
            a.alloc_pages(s, 1, 2, 9)
        assert a.alloc_pages(s, 3) == [0, 1, 2]
        assert a.alloc_pages(s, 2) is None
        assert a.page_free_count() == 1 and a.pages(s) == [0, 1, 2]


# ---------------------------------------------------------------------------
# banks and the packer against the JAX reference banks
# ---------------------------------------------------------------------------

class TestBanksAndPacker:
    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_bank_gather_scatter_match_jax(self, backend):
        """Port banks (reference indexing, or the cuda bank's kernel twins
        on CPU tensors) against the JAX reference bank, sentinel scatter
        ids included."""
        data, gidx, sidx, src = _bank_case(7, 12, 8, 5)
        lens = np.arange(12, dtype=np.int32) + 1
        new_lens = np.arange(5, dtype=np.int32) + 20
        jb, tb = JBank(12, 8), CPMBank(12, 8, backend=backend)
        jb.data, jb.lens = jnp.asarray(data), jnp.asarray(lens)
        tb.data, tb.lens = _t(data), _t(lens)
        np.testing.assert_array_equal(tb.gather(_t(gidx)).numpy(),
                                      np.asarray(jb.gather(
                                          jnp.asarray(gidx))))
        jb.scatter(jnp.asarray(sidx), jnp.asarray(src),
                   jnp.asarray(new_lens))
        tb.scatter(_t(sidx), _t(src), _t(new_lens))
        np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
        np.testing.assert_array_equal(tb.lens.numpy(), np.asarray(jb.lens))

    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_write_read_roundtrip(self, backend):
        b = CPMBank(4, 16, backend=backend)
        b.write_row(2, np.arange(5) + 1)
        row, ln = b.read_row(2)
        assert ln == 5
        np.testing.assert_array_equal(row[:5], [1, 2, 3, 4, 5])
        assert (row[5:] == 0).all()
        b.clear_row(2)
        assert b.read_row(2)[1] == 0
        with pytest.raises(ValueError, match="width"):
            b.write_row(0, np.arange(17))

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("backend", ["reference", "cuda"])
    def test_packed_commit_bit_identical_to_jax(self, seed, backend):
        rng = np.random.default_rng(seed)
        rows, width, k = 4, 24, 3
        data = rng.integers(0, 100, (rows, width)).astype(np.int32)
        lens = rng.integers(0, width - k + 1, rows).astype(np.int32)
        toks = rng.integers(0, 100, (rows, k)).astype(np.int32)
        emit = rng.integers(0, k + 1, rows).astype(np.int32)
        jd, jl = jpacked_commit("reference", None, rows, k)(
            jnp.asarray(data), jnp.asarray(lens), jnp.asarray(toks),
            jnp.asarray(emit))
        td, tl = packed_commit(backend, rows, k)(_t(data), _t(lens),
                                                 _t(toks), _t(emit))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))

    @pytest.mark.parametrize("slots", [(1, 3), (2, 0, 1), (3, 0, 2, 1)])
    def test_scheduler_flush_matches_jax(self, slots):
        """Partial and full (shuffled) banks: idle rows keep their live
        region, operands land by slot, counters agree."""
        jbank, tbank = JBank(4, 12), CPMBank(4, 12)
        for slot in range(4):
            jbank.write_row(slot, jnp.full((3,), 10 + slot), 3)
            tbank.write_row(slot, np.full((3,), 10 + slot), 3)
        js, ts = JSched([jbank]), MultiBankScheduler([tbank])
        for slot in slots:
            for sched, used in ((js, int(jbank.lens[slot])),
                                (ts, int(tbank.lens[slot]))):
                sched.submit(0, slot, [
                    ("insert", {"pos": used,
                                "values": np.asarray([90 + slot], np.int32)}),
                    ("truncate", {"new_len": used + 1})])
        assert ts.flush() == js.flush()
        np.testing.assert_array_equal(tbank.data.numpy(),
                                      np.asarray(jbank.data))
        np.testing.assert_array_equal(tbank.lens.numpy(),
                                      np.asarray(jbank.lens))
        assert ts.bank_launches == js.bank_launches == 1

    def test_scheduler_rejects_mixed_templates_and_twin_slots(self):
        sched = MultiBankScheduler([CPMBank(2, 8)])
        sched.submit(0, 0, [("truncate", {"new_len": 1})])
        sched.submit(0, 1, [("insert", {"pos": 0, "values": [1]})])
        with pytest.raises(ValueError, match="templates"):
            sched.flush()
        sched = MultiBankScheduler([CPMBank(2, 8)])
        sched.submit(0, 1, [("truncate", {"new_len": 1})])
        sched.submit(0, 1, [("truncate", {"new_len": 2})])
        with pytest.raises(ValueError, match="slot 1"):
            sched.flush()

    def test_two_schedulers_keep_separate_series(self):
        a, b = MultiBankScheduler([CPMBank(2, 4)]), \
            MultiBankScheduler([CPMBank(2, 4)])
        a.submit(0, 0, [("truncate", {"new_len": 0})])
        a.flush()
        assert a.bank_launches == 1 and b.bank_launches == 0


def test_session_table_fifo_lifecycle():
    t = SessionTable()
    a = t.add(torch.arange(3), 3, 5)
    b = t.add(torch.arange(4), 4, 2)
    assert t.next_waiting() is a
    t.activate(a.sid, 0, 1)
    assert t.at_slot(1) is a and t.next_waiting() is b
    t.park(a.sid)
    assert t.parked_count() == 1 and t.peek_waiting(2) == [b, a]
    t.activate(a.sid, 0, 0)
    t.finish(a.sid, np.arange(8))
    t.finish(b.sid, np.arange(4))          # cancelled while waiting
    assert t.all_done() and set(t.collect_finished()) == {a.sid, b.sid}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestRowKernelsOnCard:
    """Each row kernel against its plain twin on the same card inputs, at
    the pool's shapes and a few ragged ones, sentinels included."""

    @pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int8])
    @pytest.mark.parametrize("r,n,k", _ROW_CASES + [(24, 32, 0),
                                                    (300, 129, 40)])
    def test_row_kernels_bit_identical(self, cuda_device, r, n, k, dtype):
        data, gidx, sidx, src = _bank_case(r + n + k, r, n, k, dtype)
        d, g, s, x = (_t(a).to(cuda_device) for a in (data, gidx, sidx, src))
        ops.reset_launch_counts()
        got_g = TK.gather_rows(d, g)
        got_s = TK.scatter_rows(d, s, x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts["gather_rows"] == (1 if k else 0)
        assert counts["scatter_rows"] == 1
        assert torch.equal(got_g, TK.gather_rows_plain(d, g))
        assert torch.equal(got_s, TK.scatter_rows_plain(d, s, x))

    def test_wrappers_reject_what_the_kernel_does_not_take(self,
                                                           cuda_device):
        d = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="int32"):
            TK.gather_rows(d, torch.zeros(2, dtype=torch.int64,
                                          device=cuda_device))
        with pytest.raises(ValueError, match="contiguous"):
            TK.gather_rows(d.t(), torch.zeros(2, dtype=torch.int32,
                                              device=cuda_device))
