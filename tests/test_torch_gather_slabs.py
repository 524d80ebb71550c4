"""T1's forms (``gather_probe.cu``), held on the CPU.

The gather takes one of four forms, as ``tools.gather_probe.
gather_slab_plan`` picks them: "device" (every single gather, k = 1, and
every chain shorter than ``stage_min_k`` of its height's staged form: one
thread an element, the table where it lies), and for longer chains "block"
(the table whole in each block), "multicast" (a block serves 8 lanes and
holds their slab of every row, a cluster of 2 blocks loading it once by TMA
multicast) and "column" (a block serves one lane and holds its column,
filled by loads of the table). A staged form's launch geometry does not
depend on k, so its model walks any chain length. The CUDA kernel does not
run here, so this file holds what its forms are built from: numpy models of
the kernel's walks, written from the plan as the kernel walks it (the
element grid; the clusters and ranks of the multicast grid, the TMA boxes
each block issues and where they land, the expect-tx bytes of each block's
barrier; the column's fill; the thread -> (row, lane) map, 4 output rows a
thread at once), show that

* every output element (r, l) is computed by exactly one thread;
* each table sector (32 bytes: 8 lanes of a row) is loaded once a cluster
  (multicast), every block receives exactly the bytes its barrier expects,
  and every column word is filled once (column);
* each block's shared memory stays within 227 KB;
* the models' output equals ``np.take_along_axis``, the plain version and
  the JAX tool's bodies (through ``pl.pallas_call(interpret=True)``, as
  ``test_torch_probes.py`` runs them) for the gather and both chains;

and counts the shared-memory bank conflicts of the staged layouts (the
slab dense, row q's 8 words at 8q; the column dense, row q in bank q mod
32) against a bound, beside a padded slab layout that spreads a lane over
every bank. Everything here is exact.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.tools import gather_probe as gp
from test_torch_probes import _jax_gather, _jax_gather_chain, _jax_sweep_chain
import torch_workers  # noqa: F401

SMEM_MAX = 227 * 1024
ILP = 4  # output rows a thread walks at once (gather_probe.cu SLAB_ILP)
BANKS = 32


def _step(table, acc, step, update, rows):
    """One step of a chain in numpy (int64), the kernel's update."""
    if update == "chain":
        return np.abs(table + step) % rows
    return np.abs(table + acc + step) % 255


def _chain(fetch, acc, k, update, rows):
    """k steps of ``update`` with the table row fetched by ``fetch(q)``."""
    for step in range(k):
        q = acc if update == "chain" else acc & (rows - 1)
        acc = _step(fetch(q), acc, step, update, rows)
    return acc


def _wavefronts(words, busy=None):
    """The wavefronts each warp's shared-memory read takes: ``words`` (warps,
    32) word addresses, -1 where a thread reads nothing; the most distinct
    words one bank serves (a word read by several threads is one)."""
    banks = np.where(words >= 0, words % BANKS, BANKS)
    key = np.sort(banks * (1 << 24) + np.maximum(words, 0), axis=-1)
    distinct = np.concatenate([np.ones((len(key), 1), bool), key[:, 1:] != key[:, :-1]], axis=1)
    counts = np.zeros((len(key), BANKS + 1), np.int64)
    np.add.at(counts, (np.arange(len(key))[:, None], key >> 24), distinct)
    most = counts[:, :-1].max(1)
    return most if busy is None else most[busy]


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


def element_model(table, idx, k, update, plan, seed=0):
    """The walk of ``gather_block_kernel`` (device and block forms): thread
    t of block b takes element e = b * threads + t, (r, l) = divmod(e,
    lanes), fetching table row q lane l from device memory or from the
    block's staged copy. Returns (out, computed)."""
    rows, lanes = table.shape
    n = idx.shape[0]
    assert plan.form in ("device", "block") and plan.cluster == 1
    n_el = n * lanes
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.grid * plan.threads >= n_el > (plan.grid - 1) * plan.threads
    if plan.form == "block":
        assert plan.smem_bytes == rows * lanes * 4 <= SMEM_MAX and plan.slab_rows == rows
    else:
        assert plan.smem_bytes == 0 and plan.slab_rows == 0
    e = np.arange(plan.grid * plan.threads)
    e = e[e < n_el]
    r, l = e // lanes, e % lanes
    acc = idx[r, l].astype(np.int64)
    assert update == "sweep" or np.all((acc >= 0) & (acc < rows))
    # The staged copy: random shared memory, then the table word for word.
    smem = np.random.RandomState(seed).randint(-2**31, 2**31, rows * lanes,
                                               dtype=np.int64).astype(np.int32)
    smem[:] = table.reshape(-1)
    src = table.reshape(-1) if plan.form == "device" else smem
    fetch = lambda q: src[q * lanes + l].astype(np.int64)  # noqa: E731
    acc = fetch(acc) if update == "none" else _chain(fetch, acc, k, update, rows)
    out = np.zeros((n, lanes), np.int32)
    computed = np.zeros((n, lanes), np.int64)
    out[r, l] = acc
    np.add.at(computed, (r, l), 1)
    return out, computed


def _grid(plan):
    """(lane group, block of the group, cluster id, rank) of every block of
    the multicast form."""
    c = plan.cluster
    per_group = gp.SLAB_BLOCKS // c
    blk = np.arange(plan.grid)
    cid, rank = blk // c, blk % c
    g = cid // per_group
    return g, (cid - g * per_group) * c + rank, cid, rank


def _load_slabs(table, plan, seed=0):
    """The TMA phase: each block's shared memory (slab_rows x 8 int32,
    random before the copies), the sector loads counted per cluster, and
    the bytes each block's barrier received."""
    rows, lanes = table.shape
    rng = np.random.RandomState(seed)
    g, _, cid, rank = _grid(plan)
    box = gp.SLAB_BOX_ROWS
    smem = rng.randint(-2**31, 2**31, (plan.grid, plan.slab_rows, gp.SLAB_LANES),
                       dtype=np.int64).astype(np.int32)
    landed = np.zeros((plan.grid, plan.slab_rows), np.int64)
    sectors = np.zeros((plan.grid // plan.cluster, rows), np.int64)  # by cluster
    expect = np.zeros(plan.grid, np.int64)
    boxes = plan.slab_rows // box
    for b_ in range(plan.grid):
        lanes_g = slice(gp.SLAB_LANES * g[b_], gp.SLAB_LANES * (g[b_] + 1))
        expect[b_] = boxes * box * gp.SLAB_LANES * 4
        for b in range(rank[b_], boxes, plan.cluster):
            # Rows [top, top + 256) of the lane group: out-of-bounds rows fill with 0.
            data = np.zeros((box, gp.SLAB_LANES), np.int32)
            live = np.arange(b * box, min(b * box + box, rows))
            data[:len(live)] = table[live, lanes_g]
            sectors[cid[b_], live] += 1
            for dest in np.nonzero(cid == cid[b_])[0]:  # .multicast::cluster
                smem[dest, b * box:(b + 1) * box] = data
                landed[dest, b * box:(b + 1) * box] += 1
    received = landed.sum(1) * gp.SLAB_LANES * 4
    assert np.array_equal(received, expect)  # each barrier completes, once
    assert landed.max() <= 1
    return smem, sectors


def _thread_rows(r0, r1, per_pass, width):
    """(batch, u, row slot j, lane of the slot) -> row r = r0 + batch *
    per_pass * 4 + u * per_pass + j, for row slots of ``width`` lanes."""
    batches = -(-(r1 - r0) // (per_pass * ILP))
    rr = (r0 + np.arange(batches)[:, None, None, None] * per_pass * ILP
          + np.arange(ILP)[None, :, None, None] * per_pass
          + np.arange(per_pass)[None, None, :, None]
          + np.zeros(width, np.int64)[None, None, None, :])
    return rr, batches


def slab_model(table, idx, k, update, plan, seed=0):
    """The walk of ``gather_multicast_kernel``: (out, computed, conflicts).
    ``computed`` counts the threads that computed each (r, l); ``conflicts``
    holds, for every warp's fetch, the wavefronts shared memory serves it
    in (the most distinct words in one bank)."""
    rows, lanes = table.shape
    n = idx.shape[0]
    assert update in ("chain", "sweep") and k >= 2
    assert plan.form == "multicast" and plan.threads == 1024 and plan.cluster == 2
    assert plan.grid == lanes // gp.SLAB_LANES * gp.SLAB_BLOCKS
    assert plan.smem_bytes == (plan.slab_rows * 32 + gp.SLAB_ALIGN + gp.SLAB_BARRIER) <= SMEM_MAX
    assert plan.slab_rows % gp.SLAB_BOX_ROWS == 0 and plan.slab_rows >= rows
    smem, sectors = _load_slabs(table, plan, seed)
    assert np.all(sectors == 1)  # each sector once a cluster
    g, bi, _, _ = _grid(plan)
    out = np.zeros((n, lanes), np.int32)
    computed = np.zeros((n, lanes), np.int64)
    conflicts = []
    for b_ in range(plan.grid):
        r0 = bi[b_] * plan.rows_per_block
        r1 = min(n, r0 + plan.rows_per_block)
        if r0 >= r1:
            continue
        # Row slots a pass: no more than the block's rows fill (threads of
        # the other slots take no row).
        per_pass = min(plan.threads // gp.SLAB_LANES, -(-(r1 - r0) // ILP))
        rr, batches = _thread_rows(r0, r1, per_pass, gp.SLAB_LANES)
        ll = np.broadcast_to(np.arange(gp.SLAB_LANES), rr.shape)
        lane = gp.SLAB_LANES * g[b_] + ll
        live = rr < r1
        acc = np.where(live, idx[np.minimum(rr, n - 1), lane], 0).astype(np.int64)
        assert update == "sweep" or np.all((acc >= 0) & (acc < rows))

        def fetch(q):
            words = q * gp.SLAB_LANES + ll
            # A warp: 32 consecutive threads, 4 row slots of 8 lanes, one
            # (batch, u) at a time; the slots past per_pass take no row and
            # issue nothing (-1 below).
            pad = [(0, 0), (0, 0), (0, -per_pass % 4), (0, 0)]
            w = np.pad(words, pad, constant_values=-1).reshape(-1, 32)
            busy = np.pad(live, pad).reshape(-1, 32).any(1)  # warps with a live thread
            conflicts.append(_wavefronts(w, busy))
            return smem[b_, q, ll].astype(np.int64)

        acc = _chain(fetch, acc, k, update, rows)
        out[rr[live], lane[live]] = acc[live]
        np.add.at(computed, (rr[live], lane[live]), 1)
    return out, computed, np.concatenate(conflicts)


def column_model(table, idx, k, update, plan, seed=0):
    """The walk of ``gather_column_kernel``: block b serves lane b; its
    column (rows words, random before the fill) is filled by loads of the
    row-major table (each row's word by one thread, a 32-byte sector a
    word); thread t takes row slot t of the block's passes. Returns (out,
    computed, conflicts, sectors read by the fill)."""
    rows, lanes = table.shape
    n = idx.shape[0]
    assert update in ("chain", "sweep") and k >= 2
    assert plan.form == "column" and plan.cluster == 1 and plan.threads == 1024
    assert plan.grid == lanes and plan.rows_per_block == n and plan.slab_rows == rows
    assert plan.smem_bytes == rows * 4 <= SMEM_MAX
    rng = np.random.RandomState(seed)
    out = np.zeros((n, lanes), np.int32)
    computed = np.zeros((n, lanes), np.int64)
    conflicts = []
    sectors = 0
    per_pass = min(plan.threads, -(-n // ILP))
    for b in range(plan.grid):
        column = rng.randint(-2**31, 2**31, rows, dtype=np.int64).astype(np.int32)
        filled = np.zeros(rows, np.int64)
        # Thread t loads rows t, t + 1024, ...: each row's word once; a
        # warp's load of 32 rows touches the distinct sectors of its words.
        q = np.arange(rows)
        column[q] = table.reshape(-1)[q * lanes + b]
        filled[q] += 1
        warp_sectors = np.pad((q * lanes + b) * 4 // 32, (0, -rows % 32),
                              constant_values=-1).reshape(-1, 32)
        sectors += sum(len(set(w[w >= 0])) for w in warp_sectors)
        assert np.all(filled == 1)
        rr, _ = _thread_rows(0, n, per_pass, 1)
        rr = rr[..., 0]  # (batch, u, slot)
        live = rr < n
        acc = np.where(live, idx[np.minimum(rr, n - 1), b], 0).astype(np.int64)
        assert update == "sweep" or np.all((acc >= 0) & (acc < rows))

        def fetch(q):
            assert np.all((q >= 0) & (q < rows))
            # A warp: 32 consecutive row slots, one (batch, u) at a time.
            pad = [(0, 0), (0, 0), (0, -per_pass % 32)]
            w = np.pad(np.where(live, q, -1), pad, constant_values=-1).reshape(-1, 32)
            busy = np.pad(live, pad).reshape(-1, 32).any(1)
            conflicts.append(_wavefronts(w, busy))
            return column[q].astype(np.int64)

        acc = _chain(fetch, acc, k, update, rows)
        out[rr[live], b] = acc[live]
        np.add.at(computed, (rr[live], np.full(live.sum(), b)), 1)
    return out, computed, np.concatenate(conflicts), sectors


def staged_plan(rows, n, lanes):
    """The launch of the staged form at this height (its geometry is the
    same at every chain length the plan takes it for)."""
    return gp.gather_slab_plan(rows, n, lanes, gp.stage_min_k(rows, lanes), "chain")


def model(table, idx, k, update, staged=False):
    """The model of the plan's form (``staged``: of the height's staged
    form, at any k): (plan, out, conflicts); each (r, l) by exactly one
    thread, == the plain version."""
    rows, lanes = table.shape
    n = idx.shape[0]
    plan = staged_plan(rows, n, lanes) if staged else gp.gather_slab_plan(rows, n, lanes, k,
                                                                          update)
    conflicts = None
    if plan.form in ("device", "block"):
        out, computed = element_model(table, idx, k, update, plan)
    elif plan.form == "multicast":
        out, computed, conflicts = slab_model(table, idx, k, update, plan)
    else:
        out, computed, conflicts, _ = column_model(table, idx, k, update, plan)
    assert np.all(computed == 1)  # each (r, l) by exactly one thread
    np.testing.assert_array_equal(out, _plain(table, idx, k, update))
    return plan, out, conflicts


def _plain(table, idx, k, update):
    return gp.gather_chain_plain(torch.from_numpy(table), torch.from_numpy(idx), k,
                                 update).numpy()


# ---------------------------------------------------------------------------
# (a) The plans
# ---------------------------------------------------------------------------


LONG_K = 1024  # a chain every staged form is taken for


@pytest.mark.parametrize("rows,form,cluster,slab_rows,smem", [
    (64, "block", 1, 64, 32768), (454, "block", 1, 454, 232448),
    (455, "multicast", 2, 512, 16528), (512, "multicast", 2, 512, 16528),
    (1024, "multicast", 2, 1024, 32912), (4096, "multicast", 2, 4096, 131216),
    (7168, "multicast", 2, 7168, 229520), (7169, "column", 1, 7169, 28676),
    (16384, "column", 1, 16384, 65536), (32768, "column", 1, 32768, 131072)])
def test_plans_by_table_height(rows, form, cluster, slab_rows, smem):
    """A long chain's form by table height at 128 lanes, the table rows a
    block holds and its shared memory (a slab from a 128-byte boundary,
    then its barrier; a column as it lies)."""
    for update in ("chain", "sweep"):
        plan = gp.gather_slab_plan(rows, rows, gp.LF, LONG_K, update)
        assert (plan.form, plan.cluster, plan.slab_rows, plan.smem_bytes) == (
            form, cluster, slab_rows, smem)
    assert plan.smem_bytes <= SMEM_MAX and gp.staged_form(rows, gp.LF) == form
    table = torch.empty((rows, gp.LF), dtype=torch.int32)
    assert (form == "block") == gp.table_in_smem(table)
    if form == "multicast":
        assert plan.grid == 128 and plan.threads == 1024
        assert plan.rows_per_block == -(-rows // 8)
    if form == "column":
        assert (plan.grid, plan.threads, plan.rows_per_block) == (gp.LF, 1024, rows)


@pytest.mark.parametrize("rows", (256, 454, 455, 1024, 4096, 7168, 7169, 16384, 32768))
def test_chain_plan_by_length(rows):
    """A chain shorter than its height's ``stage_min_k`` takes the
    device form (the L2 line's launch, which wins there); from it on, the
    staged form, whose launch is the same at every such k."""
    form = gp.staged_form(rows, gp.LF)
    k_min = gp.stage_min_k(rows, gp.LF)
    assert k_min >= 2
    for n in (rows, 37):
        staged = gp.gather_slab_plan(rows, n, gp.LF, k_min, "chain")
        assert staged.form == form
        assert gp.gather_slab_plan(rows, n, gp.LF, k_min + 1000, "chain") == staged
        for k in range(2, k_min):
            assert gp.gather_slab_plan(rows, n, gp.LF, k, "chain") == gp.device_plan(n, gp.LF)


@pytest.mark.parametrize("rows", (64, 454, 455, 4096, 7169, 16384, 32768, 1 << 20))
def test_single_gather_plan_is_the_device_form(rows):
    """A single gather (k = 1, every update) reads the table where it lies
    at every height: one thread an element, no shared memory, any width."""
    for update in gp.UPDATES:
        for n, lanes in ((rows, gp.LF), (37, 100), (1, 1)):
            if update == "sweep" and rows & (rows - 1):
                continue
            plan = gp.gather_slab_plan(rows, n, lanes, 1, update)
            n_el = n * lanes
            threads = 1024 if n_el >= 1024 else -(-n_el // 32) * 32
            assert plan == gp.GatherPlan("device", 1, -(-threads // lanes), 0, threads,
                                         -(-n_el // threads), 0)
            assert plan == gp.device_plan(n, lanes)


def test_block_plan_is_the_old_launch():
    """The block form launches as the probe always did: one thread an
    element, blocks of up to 1024 threads."""
    k = max(gp.stage_min_k(256, 128), gp.stage_min_k(64, 8))
    assert gp.gather_slab_plan(256, 256, 128, k, "chain") == gp.GatherPlan(
        "block", 1, 8, 256, 1024, 32, 131072)
    assert gp.gather_slab_plan(64, 3, 8, k, "sweep") == gp.GatherPlan("block", 1, 4, 64, 32, 1,
                                                                      2048)


@pytest.mark.parametrize("args,match", [
    ((4096, 4096, 100, 2, "chain"), "multiples of 8"), ((4096, 64, 20, 68, "sweep"),
                                                        "multiples of 8"),
    ((7168, 16384, 130, 2, "chain"), "multiples of 8"), ((455, 455, 130, 3, "chain"),
                                                         "multiples of 8"),
    ((32769, 8, 128, 2, "chain"), "does not fit"), ((1 << 20, 8, 8, 2, "chain"),
                                                    "does not fit"),
    ((40000, 8, 128, 68, "chain"), "does not fit"), ((0, 8, 128, 1, "none"), "no gather plan"),
    ((64, 0, 128, 1, "none"), "no gather plan"), ((64, 8, 128, 2, "none"), "k must be 1"),
    ((64, 8, 128, 2, "other"), "update must be")])
def test_plan_refuses(args, match):
    """Widths that are not whole lane groups at multicast heights and
    tables no form holds (for every chain, staged or not), and what is not
    a chain."""
    with pytest.raises(ValueError, match=match):
        gp.gather_slab_plan(*args)


def test_the_kernel_computes_the_same_plan():
    """``gather_probe.cu``'s constants are the plan's."""
    src = (gp.build.CSRC / "gather_probe.cu").read_text()
    for name, value in (("SLAB_LANES", gp.SLAB_LANES), ("SLAB_BOX_ROWS", gp.SLAB_BOX_ROWS),
                        ("SLAB_THREADS", gp.SLAB_THREADS), ("SLAB_ILP", ILP),
                        ("SLAB_BLOCKS", gp.SLAB_BLOCKS), ("SLAB_ALIGN", gp.SLAB_ALIGN),
                        ("SLAB_MULTICAST_CLUSTER", gp.MULTICAST_CLUSTER),
                        ("SLAB_BARRIER", gp.SLAB_BARRIER),
                        ("COLUMN_MAX_ROWS", gp.COLUMN_MAX_ROWS)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int ANY_ROWS = 1 << 30;" in src and gp.ANY_ROWS == 1 << 30
    bands = ", ".join(f"{{DPT_GATHER_{form.upper()}, {'ANY_ROWS' if last == gp.ANY_ROWS else last}"
                      f", {k}}}" for form, last, k in gp.STAGE_BANDS)
    assert f"STAGE_BANDS[] = {{{bands}}};" in " ".join(src.split()), bands
    launchers = (gp.build.CSRC / "launchers.h").read_text()
    for i, form in enumerate(gp.GATHER_FORMS):
        assert f"constexpr int DPT_GATHER_{form.upper()} = {i};" in launchers
    assert "map_shared_rank" not in src and "DPT_MAX_CLUSTER" not in src
    assert "cp.async.bulk.shared" not in src.replace("cp.async.bulk.tensor", "")


# ---------------------------------------------------------------------------
# (b) The models against the plain version, numpy and the JAX bodies
# ---------------------------------------------------------------------------

# (rows, n, lanes): n != rows, n not a multiple of C or of 8, several lane
# groups, tables of every height the probe uses.
SHAPES = [(512, 512, 128), (512, 37, 128), (1024, 333, 128), (4096, 1000, 64),
          (4096, 4096, 128), (16384, 777, 16), (16384, 100, 24), (7169, 50, 16)]


def _numpy_chain(tbl, idx, k):
    """k dependent gathers of the "chain" update by ``np.take_along_axis``."""
    rows = tbl.shape[0]
    acc = idx.astype(np.int64)
    for step in range(k):
        acc = np.abs(np.take_along_axis(tbl, acc, axis=0).astype(np.int64) + step) % rows
    return acc


@pytest.mark.parametrize("rows,n,lanes", SHAPES)
def test_gather_model_equals_numpy_and_jax(rows, n, lanes):
    """The single gather, in the device form at every height."""
    rng = np.random.RandomState(rows + n)
    tbl = np.arange(rows * lanes, dtype=np.int32).reshape(rows, lanes)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    plan, out, _ = model(tbl, idx, 1, "none")
    assert plan.form == "device"
    np.testing.assert_array_equal(out, np.take_along_axis(tbl, idx, axis=0))
    np.testing.assert_array_equal(out, _jax_gather(tbl, idx))


@pytest.mark.parametrize("rows,n,lanes", [
    (512, 512, 128), (1024, 333, 128), (4096, 1001, 64), (455, 9, 128), (768, 1, 128),
    (2048, 2047, 32), (4097, 3, 56), (6000, 64, 16), (7168, 129, 16)])
def test_multicast_model(rows, n, lanes):
    """The multicast form over clusters of 2 on every slab height it takes
    (455 to 7168 rows), a chain of 2: each sector once a cluster, each
    element once, == numpy's two gathers."""
    rng = np.random.RandomState(rows + n)
    tbl = rng.randint(0, rows, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    plan, out, _ = model(tbl, idx, 2, "chain", staged=True)
    assert plan.cluster == gp.MULTICAST_CLUSTER and plan.form == "multicast"
    np.testing.assert_array_equal(out, _numpy_chain(tbl, idx, 2))


@pytest.mark.parametrize("rows,n,lanes", [
    (7169, 50, 16), (8192, 1, 8), (16384, 777, 16), (16384, 4100, 7), (20001, 333, 5),
    (32768, 64, 4), (7169, 4097, 9), (10000, 1, 6), (12345, 2000, 9), (24576, 300, 3),
    (32767, 17, 5), (31000, 1025, 4)])
def test_column_model(rows, n, lanes):
    """The column form on the heights it takes (7169 to 32768 rows), odd
    output rows and widths, a chain of 2: each column word filled once,
    each element once, == numpy's two gathers; the fill reads a 32-byte
    sector a word."""
    rng = np.random.RandomState(rows + n + lanes)
    tbl = rng.randint(0, rows, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    plan = staged_plan(rows, n, lanes)
    out, computed, _, sectors = column_model(tbl, idx, 2, "chain", plan)
    assert plan.form == "column" and np.all(computed == 1)
    np.testing.assert_array_equal(out, _numpy_chain(tbl, idx, 2))
    np.testing.assert_array_equal(out, _plain(tbl, idx, 2, "chain"))
    if lanes >= 8:
        assert sectors == lanes * rows  # 8 times a lane-major copy's at 8 lanes and up
    else:
        assert sectors >= -(-lanes * rows * 4 // 32)


@pytest.mark.parametrize("k", (1, 68))
@pytest.mark.parametrize("rows,n,lanes", [(1024, 333, 128), (4096, 1000, 64),
                                          (16384, 500, 16)])
def test_chain_model_equals_plain(rows, n, lanes, k):
    """The "chain" update, k dependent gathers, in the form the plan takes
    (device at k = 1 and below the staged form's shortest chain; else
    multicast or column)."""
    rng = np.random.RandomState(k)
    tbl = rng.randint(0, rows, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    plan, _, _ = model(tbl, idx, k, "chain")
    form = gp.staged_form(rows, lanes)
    assert plan.form == ("device" if k < max(2, gp.stage_min_k(rows, lanes)) else form)
    if k > 1:
        assert model(tbl, idx, k, "chain", staged=True)[0].form == form


@pytest.mark.parametrize("k", (1, 68))
@pytest.mark.parametrize("rows,n,lanes", [(1024, 8, 128), (4096, 99, 16), (16384, 300, 8)])
def test_sweep_update_model_equals_plain_and_the_sweep(rows, n, lanes, k):
    """The "sweep" update (the fetch of the select sweep by one load),
    start values outside the table masked, in the plan's form and (chains)
    the height's staged form, and on the sweep's own tile the JAX select
    sweep's output at k = 1."""
    rng = np.random.RandomState(rows + k)
    tbl = rng.randint(0, 255, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, 1 << 20, (n, lanes)).astype(np.int32)
    _, out, _ = model(tbl, idx, k, "sweep")
    if k > 1:
        np.testing.assert_array_equal(model(tbl, idx, k, "sweep", staged=True)[1], out)
    if k == 1 and rows == 1024:
        np.testing.assert_array_equal(out, _jax_sweep_chain(tbl, idx, 1))


@pytest.mark.parametrize("rows,n,lanes,k", [(1024, 100, 128, 3), (16384, 40, 8, 2),
                                            (9000, 77, 4, 5)])
def test_chain_model_equals_jax_body(rows, n, lanes, k):
    """The JAX chain's body against the multicast and the column forms
    and against the plan's form."""
    tbl, _ = gp.chain_inputs(rows, lanes)
    idx = np.random.RandomState(5).randint(0, rows, (n, lanes)).astype(np.int32)
    want = _jax_gather_chain(tbl, idx, k)
    for staged in (False, True):
        _, out, _ = model(tbl, idx, k, "chain", staged=staged)
        np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# (c) Bank conflicts of the staged layouts
# ---------------------------------------------------------------------------

# The most wavefronts a warp's fetch takes on average, random rows. The
# dense slab: each lane's 4 reads fall in its 4 banks 8 (q mod 4) + l, so a
# warp waits for the busiest of 8 such draws (about 2.96 expected). The
# dense column: row q in bank q mod 32, a warp's 32 rows land as 32 random
# draws of 32 banks (about 3.53 expected).
MEAN_WAVEFRONTS_MAX = {"multicast": 3.1, "column": 3.7}


def _spread_wavefronts(idx_rows, lanes_l):
    """Wavefronts of a warp under a padded slab (pitch 9 words: lane l of
    row q in bank (9q + l) mod 32), which spreads every lane over all
    banks: 32 reads land like 32 random draws."""
    words = idx_rows * 9 + lanes_l
    banks = words % BANKS
    counts = np.zeros((len(words), BANKS), np.int64)
    np.add.at(counts, (np.arange(len(words))[:, None], banks), 1)
    return counts.max(1)


@pytest.mark.parametrize("rows", (4096, 16384))
def test_dense_slab_bank_conflicts(rows):
    """The first step of a chain on the tool's random indices at the
    probe's width: the mean wavefronts a warp's fetch takes stays under the
    form's bound and is one wavefront at best. The dense slab (4096 rows)
    beats the padded slab layout, which lands like the column (16384
    rows): 32 random draws."""
    tbl, idx = gp.chain_inputs(rows)
    idx = idx[:4096]  # 512 output rows a multicast block: each thread's 4 rows live
    plan, _, conflicts = model(tbl, idx, 2, "chain", staged=True)
    mean = conflicts.mean()
    q = idx.reshape(-1, 4, 128)[:, :, :8].reshape(-1, 32)  # 4 rows x 8 lanes a warp
    spread = _spread_wavefronts(q, np.tile(np.arange(8), 4)[None, :])
    print(f"{plan.form}: {conflicts.size} warp fetches, {mean:.3f} wavefronts each on "
          f"average, {conflicts.max()} at most; the padded slab layout {spread.mean():.3f}")
    assert plan.form == ("multicast" if rows == 4096 else "column")
    assert 1 <= conflicts.min() and mean <= MEAN_WAVEFRONTS_MAX[plan.form]
    if plan.form == "multicast":
        assert mean < spread.mean()
    else:
        assert abs(mean - spread.mean()) < 0.1


# ---------------------------------------------------------------------------
# (d) The L2 line: the device form at any k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,update,k", [
    (64, 64, "none", 1), (4096, 4096, "none", 1), (16384, 777, "none", 1),
    (1024, 333, "chain", 68), (16384, 100, "chain", 3), (4096, 99, "sweep", 5)])
def test_l2_line_equals_the_gather(rows, n, update, k):
    """``gather_chain_l2`` computes ``gather_chain``'s function (on a CPU
    tensor both run the plain version and launch nothing), == the device
    form's model, numpy and the JAX bodies."""
    rng = np.random.RandomState(rows + n + k)
    tbl = rng.randint(0, min(rows, 255) if update == "sweep" else rows,
                      (rows, gp.LF)).astype(np.int32)
    idx = rng.randint(0, rows, (n, gp.LF)).astype(np.int32)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    gp.build.reset_launch_counts()
    ours = gp.gather_chain_l2(t, i, k, update).numpy()
    assert not gp.build.LAUNCHES
    np.testing.assert_array_equal(ours, gp.gather_chain(t, i, k, update).numpy())
    np.testing.assert_array_equal(ours, element_model(tbl, idx, k, update,
                                                      gp.device_plan(n, gp.LF))[0])
    if update == "none":
        np.testing.assert_array_equal(ours, np.take_along_axis(tbl, idx, axis=0))
        np.testing.assert_array_equal(ours, _jax_gather(tbl, idx))
    elif update == "chain":
        np.testing.assert_array_equal(ours, _jax_gather_chain(tbl, idx, k))


def test_l2_line_refuses_what_the_gather_refuses():
    tbl, idx = (torch.from_numpy(a) for a in gp.chain_inputs(64))
    with pytest.raises(ValueError, match="update"):
        gp.gather_chain_l2(tbl, idx, 1, "other")
    with pytest.raises(ValueError, match="k must be 1"):
        gp.gather_chain_l2(tbl, idx, 2, "none")
    with pytest.raises(ValueError, match="power of two"):
        gp.gather_chain_l2(tbl[:48], idx, 1, "sweep")
