"""T1's lane-slab forms (``gather_probe.cu``), held on the CPU.

The gather takes one of three forms, as ``tools.gather_probe.
gather_slab_plan`` picks them: "block" (the table whole in each block),
"multicast" (a block serves 8 lanes and holds their slab of every row, a
cluster of 2 blocks loading it once by TMA multicast) and "distributed"
(the slab split by rows over a cluster of 8, read through distributed
shared memory). The CUDA kernel does not run here, so this file holds what
its slab forms are built from: a numpy model of the kernel's walk, written
from the plan as the kernel walks it (the clusters and ranks of the grid,
the TMA boxes each block issues and where they land, the expect-tx bytes
of each block's barrier, the thread -> (row, lane) map, 4 output rows a
thread at once, the fetch from the owner's shared memory), shows that

* every output element (r, l) is computed by exactly one thread;
* each table sector (32 bytes: 8 lanes of a row) is loaded once a cluster
  (multicast) or once overall (distributed), and every block receives
  exactly the bytes its barrier expects;
* each block's shared memory stays within 227 KB;
* the model's output equals ``np.take_along_axis``, the plain version and
  the JAX tool's bodies (through ``pl.pallas_call(interpret=True)``, as
  ``test_torch_probes.py`` runs them) for the gather and both chains;

and counts the shared-memory bank conflicts of the chosen layout (the slab
dense, row q's 8 words at 8q) against a bound, beside a padded layout that
spreads a lane over every bank. Everything here is exact.
"""

import numpy as np
import pytest
import torch

from dither_pie_tpu_torch.tools import gather_probe as gp
from test_torch_probes import _jax_gather, _jax_gather_chain, _jax_sweep_chain

SMEM_MAX = 227 * 1024
ILP = 4  # output rows a thread walks at once (gather_probe.cu SLAB_ILP)
BANKS = 32


def _grid(plan):
    """(lane group, block of the group, cluster id, rank) of every block."""
    c = plan.cluster
    per_group = gp.SLAB_BLOCKS // c
    blk = np.arange(plan.grid)
    cid, rank = blk // c, blk % c
    g = cid // per_group
    return g, (cid - g * per_group) * c + rank, cid, rank


def _load_slabs(table, plan, seed=0):
    """The TMA phase: each block's shared memory (slab_rows x 8 int32,
    random before the copies), the sector loads counted per cluster and
    per lane group, and the bytes each block's barrier received."""
    rows, lanes = table.shape
    rng = np.random.RandomState(seed)
    g, _, cid, rank = _grid(plan)
    box = gp.SLAB_BOX_ROWS
    smem = rng.randint(-2**31, 2**31, (plan.grid, plan.slab_rows, gp.SLAB_LANES),
                       dtype=np.int64).astype(np.int32)
    landed = np.zeros((plan.grid, plan.slab_rows), np.int64)
    sectors = np.zeros((plan.grid // plan.cluster, rows), np.int64)  # by cluster
    expect = np.zeros(plan.grid, np.int64)

    def box_rows(top):
        """Rows [top, top + 256) of the lane group: out-of-bounds rows fill with 0."""
        got = np.zeros((box, gp.SLAB_LANES), np.int32)
        live = np.arange(top, min(top + box, rows))
        return got, live

    for b_ in range(plan.grid):
        lanes_g = slice(gp.SLAB_LANES * g[b_], gp.SLAB_LANES * (g[b_] + 1))
        if plan.form == "multicast":
            boxes = plan.slab_rows // box
            expect[b_] = boxes * box * gp.SLAB_LANES * 4
            for b in range(rank[b_], boxes, plan.cluster):
                data, live = box_rows(b * box)
                data[:len(live)] = table[live, lanes_g]
                sectors[cid[b_], live] += 1
                for dest in np.nonzero(cid == cid[b_])[0]:  # .multicast::cluster
                    smem[dest, b * box:(b + 1) * box] = data
                    landed[dest, b * box:(b + 1) * box] += 1
        else:
            first = rank[b_] * plan.slab_rows
            b = 0
            while b * box < plan.slab_rows and first + b * box < rows:
                data, live = box_rows(first + b * box)
                data[:len(live)] = table[live, lanes_g]
                sectors[cid[b_], live] += 1
                smem[b_, b * box:(b + 1) * box] = data
                landed[b_, b * box:(b + 1) * box] += 1
                b += 1
            expect[b_] = b * box * gp.SLAB_LANES * 4
    received = landed.sum(1) * gp.SLAB_LANES * 4
    assert np.array_equal(received, expect)  # each barrier completes, once
    assert landed.max() <= 1
    return smem, sectors


def slab_model(table, idx, k, update, plan, seed=0):
    """The walk of ``gather_slab_kernel``: (out, computed, conflicts).
    ``computed`` counts the threads that computed each (r, l); ``conflicts``
    holds, for every warp's fetch, the wavefronts the owner's shared memory
    serves it in (the most distinct words in one bank)."""
    rows, lanes = table.shape
    n = idx.shape[0]
    assert plan.form in ("multicast", "distributed") and plan.threads == 1024
    assert plan.grid == lanes // gp.SLAB_LANES * gp.SLAB_BLOCKS
    assert plan.smem_bytes == (plan.slab_rows * 32 + gp.SLAB_ALIGN + gp.SLAB_BARRIER) <= SMEM_MAX
    assert plan.slab_rows % gp.SLAB_BOX_ROWS == 0
    if plan.form == "distributed":
        assert plan.cluster == 8 and plan.slab_rows & (plan.slab_rows - 1) == 0
        assert plan.slab_rows * plan.cluster >= rows
    else:
        assert plan.slab_rows >= rows
    smem, sectors = _load_slabs(table, plan, seed)
    if plan.form == "multicast":
        assert np.all(sectors == 1)  # each sector once a cluster
    else:
        groups = sectors.reshape(lanes // gp.SLAB_LANES, -1, rows).sum(1)
        assert np.all(groups == 1)  # each sector once overall
    g, bi, cid, rank = _grid(plan)
    out = np.zeros((n, lanes), np.int32)
    computed = np.zeros((n, lanes), np.int64)
    conflicts = []
    mask = rows - 1
    for b_ in range(plan.grid):
        r0 = bi[b_] * plan.rows_per_block
        r1 = min(n, r0 + plan.rows_per_block)
        if r0 >= r1:
            continue
        # Row slots a pass: no more than the block's rows fill (threads of
        # the other slots take no row).
        per_pass = min(plan.threads // gp.SLAB_LANES, -(-(r1 - r0) // ILP))
        batches = -(-(r1 - r0) // (per_pass * ILP))
        # (batch, u, row slot j, lane l): r = r0 + batch*per_pass*4 + u*per_pass + j.
        rr = (r0 + np.arange(batches)[:, None, None, None] * per_pass * ILP
              + np.arange(ILP)[None, :, None, None] * per_pass
              + np.arange(per_pass)[None, None, :, None]
              + np.zeros(gp.SLAB_LANES, np.int64)[None, None, None, :])
        ll = np.broadcast_to(np.arange(gp.SLAB_LANES), rr.shape)
        lane = gp.SLAB_LANES * g[b_] + ll
        live = rr < r1
        acc = np.where(live, idx[np.minimum(rr, n - 1), lane], 0).astype(np.int64)
        assert update == "sweep" or np.all((acc >= 0) & (acc < rows))
        peers = np.nonzero(cid == cid[b_])[0]  # the cluster's blocks by rank

        def fetch(q):
            if plan.form == "multicast":
                owner = np.zeros_like(q)
                local = q
                where = np.full(q.shape, b_)
            else:
                owner = q // plan.slab_rows
                local = q % plan.slab_rows
                where = peers[owner]
            words = local * gp.SLAB_LANES + ll
            # A warp: 32 consecutive threads, 4 row slots of 8 lanes, one
            # (batch, u) at a time; the slots past per_pass take no row and
            # issue nothing (-1 below).
            pad = [(0, 0), (0, 0), (0, -per_pass % 4), (0, 0)]
            w = np.pad(words, pad, constant_values=-1).reshape(batches, ILP, -1, 32)
            o = np.pad(owner, pad).reshape(w.shape)
            busy = np.pad(live, pad).reshape(-1, 32).any(1)  # warps with a live thread
            col = np.where(w >= 0, o * BANKS + w % BANKS, BANKS * plan.cluster)
            key = np.sort(col * (1 << 24) + np.maximum(w, 0), axis=-1)
            distinct = np.concatenate([np.ones(key.shape[:-1] + (1,), bool),
                                       key[..., 1:] != key[..., :-1]], axis=-1)
            flat = (key >> 24).reshape(-1, 32)
            counts = np.zeros((flat.shape[0], BANKS * plan.cluster + 1), np.int64)
            np.add.at(counts, (np.arange(flat.shape[0])[:, None], flat), distinct.reshape(-1, 32))
            conflicts.append(counts[:, :-1].max(1)[busy])
            return smem[where, local, ll].astype(np.int64)

        if update == "none":
            acc = fetch(acc)
        else:
            for step in range(k):
                if update == "chain":
                    acc = np.abs(fetch(acc) + step) % rows
                else:
                    acc = np.abs(fetch(acc & mask) + acc + step) % 255
        out[rr[live], lane[live]] = acc[live]
        np.add.at(computed, (rr[live], lane[live]), 1)
    return out, computed, np.concatenate(conflicts)


def _plain(table, idx, k, update):
    return gp.gather_chain_plain(torch.from_numpy(table), torch.from_numpy(idx), k,
                                 update).numpy()


def _hold(table, idx, k, update):
    rows, lanes = table.shape
    plan = gp.gather_slab_plan(rows, idx.shape[0], lanes)
    out, computed, conflicts = slab_model(table, idx, k, update, plan)
    assert np.all(computed == 1)  # each (r, l) by exactly one thread
    np.testing.assert_array_equal(out, _plain(table, idx, k, update))
    return plan, out, conflicts


# ---------------------------------------------------------------------------
# (a) The plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,form,cluster,slab_rows,smem", [
    (64, "block", 1, 64, 32768), (454, "block", 1, 454, 232448),
    (455, "multicast", 2, 512, 16528), (512, "multicast", 2, 512, 16528),
    (1024, "multicast", 2, 1024, 32912), (4096, "multicast", 2, 4096, 131216),
    (7168, "multicast", 2, 7168, 229520), (7169, "distributed", 8, 1024, 32912),
    (16384, "distributed", 8, 2048, 65680), (32768, "distributed", 8, 4096, 131216)])
def test_plans_by_table_height(rows, form, cluster, slab_rows, smem):
    """The form by table height at 128 lanes, the slab a block holds and its
    shared memory (the slab from a 128-byte boundary, then its barrier)."""
    plan = gp.gather_slab_plan(rows, rows, gp.LF)
    assert (plan.form, plan.cluster, plan.slab_rows, plan.smem_bytes) == (
        form, cluster, slab_rows, smem)
    assert plan.smem_bytes <= SMEM_MAX
    table = torch.empty((rows, gp.LF), dtype=torch.int32)
    assert (form == "block") == gp.table_in_smem(table)
    if form != "block":
        assert plan.grid == 128 and plan.threads == 1024
        assert plan.rows_per_block == -(-rows // 8)


def test_block_plan_is_the_old_launch():
    """The block form launches as the probe always did: one thread an
    element, blocks of up to 1024 threads."""
    assert gp.gather_slab_plan(256, 256, 128) == gp.GatherPlan("block", 1, 8, 256, 1024, 32,
                                                               131072)
    assert gp.gather_slab_plan(64, 3, 8) == gp.GatherPlan("block", 1, 4, 64, 32, 1, 2048)


@pytest.mark.parametrize("args,match", [
    ((4096, 4096, 100), "multiples of 8"), ((64, 64, 12), "multiples of 8"),
    ((16384, 16384, 130), "multiples of 8"), ((455, 455, 4), "multiples of 8"),
    ((7169, 50, 127), "multiples of 8"), ((512, 1, 7), "multiples of 8"),
    ((32769, 8, 128), "does not fit"), ((1 << 20, 8, 8), "does not fit"),
    ((40000, 8, 128), "does not fit"), ((0, 8, 128), "no gather plan"),
    ((64, 0, 128), "no gather plan")])
def test_plan_refuses(args, match):
    """Widths that are not whole lane groups, and tables no form holds."""
    with pytest.raises(ValueError, match=match):
        gp.gather_slab_plan(*args)


def test_the_kernel_computes_the_same_plan():
    """``gather_probe.cu``'s constants are the plan's."""
    src = (gp.build.CSRC / "gather_probe.cu").read_text()
    for name, value in (("SLAB_LANES", gp.SLAB_LANES), ("SLAB_BOX_ROWS", gp.SLAB_BOX_ROWS),
                        ("SLAB_THREADS", gp.SLAB_THREADS), ("SLAB_ILP", ILP),
                        ("SLAB_BLOCKS", gp.SLAB_BLOCKS), ("SLAB_ALIGN", gp.SLAB_ALIGN),
                        ("SLAB_MULTICAST_CLUSTER", gp.MULTICAST_CLUSTER),
                        ("SLAB_BARRIER", gp.SLAB_BARRIER)):
        assert f"constexpr int {name} = {value};" in src, name
    launchers = (gp.build.CSRC / "launchers.h").read_text()
    for i, form in enumerate(gp.GATHER_FORMS):
        assert f"constexpr int DPT_GATHER_{form.upper()} = {i};" in launchers


# ---------------------------------------------------------------------------
# (b) The model against the plain version, numpy and the JAX bodies
# ---------------------------------------------------------------------------

# (rows, n, lanes): n != rows, n not a multiple of C or of 8, several lane
# groups, tables of every slab height the probe uses (each too large for
# the block form at its width).
SHAPES = [(512, 512, 128), (512, 37, 128), (1024, 333, 128), (4096, 1000, 64),
          (4096, 4096, 128), (16384, 777, 16), (16384, 100, 24), (7169, 50, 16)]


@pytest.mark.parametrize("rows,n,lanes", SHAPES)
def test_gather_model_equals_numpy_and_jax(rows, n, lanes):
    rng = np.random.RandomState(rows + n)
    tbl = np.arange(rows * lanes, dtype=np.int32).reshape(rows, lanes)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    _, out, _ = _hold(tbl, idx, 1, "none")
    np.testing.assert_array_equal(out, np.take_along_axis(tbl, idx, axis=0))
    np.testing.assert_array_equal(out, _jax_gather(tbl, idx))


@pytest.mark.parametrize("rows,n,lanes", [
    (512, 512, 128), (1024, 333, 128), (4096, 1001, 64), (455, 9, 128), (768, 1, 128),
    (2048, 2047, 32), (4097, 3, 56), (6000, 64, 16), (7168, 129, 16)])
def test_multicast_model(rows, n, lanes):
    """The multicast form over clusters of 2 on every slab height it takes
    (455 to 7168 rows), full values: each sector once a cluster, each
    element once, == numpy."""
    rng = np.random.RandomState(rows + n)
    tbl = rng.randint(-2**31, 2**31, (rows, lanes), dtype=np.int64).astype(np.int32)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    plan, out, _ = _hold(tbl, idx, 1, "none")
    assert plan.cluster == gp.MULTICAST_CLUSTER and plan.form == "multicast"
    np.testing.assert_array_equal(out, np.take_along_axis(tbl, idx, axis=0))


@pytest.mark.parametrize("k", (1, 68))
@pytest.mark.parametrize("rows,n,lanes", [(1024, 333, 128), (4096, 1000, 64),
                                          (16384, 500, 16)])
def test_chain_model_equals_plain(rows, n, lanes, k):
    """The "chain" update, k dependent gathers, in every slab form."""
    rng = np.random.RandomState(k)
    tbl = rng.randint(0, rows, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, rows, (n, lanes)).astype(np.int32)
    _hold(tbl, idx, k, "chain")


@pytest.mark.parametrize("k", (1, 68))
@pytest.mark.parametrize("rows,n,lanes", [(1024, 8, 128), (4096, 99, 16), (16384, 300, 8)])
def test_sweep_update_model_equals_plain_and_the_sweep(rows, n, lanes, k):
    """The "sweep" update (the fetch of the select sweep by one load),
    start values outside the table masked, and on the sweep's own tile the
    JAX select sweep's output at k = 1."""
    rng = np.random.RandomState(rows + k)
    tbl = rng.randint(0, 255, (rows, lanes)).astype(np.int32)
    idx = rng.randint(0, 1 << 20, (n, lanes)).astype(np.int32)
    _, out, _ = _hold(tbl, idx, k, "sweep")
    if k == 1 and rows == 1024:
        np.testing.assert_array_equal(out, _jax_sweep_chain(tbl, idx, 1))


@pytest.mark.parametrize("rows,n,lanes,k", [(1024, 100, 128, 3), (16384, 40, 8, 2)])
def test_chain_model_equals_jax_body(rows, n, lanes, k):
    tbl, _ = gp.chain_inputs(rows, lanes)
    idx = np.random.RandomState(5).randint(0, rows, (n, lanes)).astype(np.int32)
    _, out, _ = _hold(tbl, idx, k, "chain")
    np.testing.assert_array_equal(out, _jax_gather_chain(tbl, idx, k))


# ---------------------------------------------------------------------------
# (c) Bank conflicts of the slab layout
# ---------------------------------------------------------------------------

# The most wavefronts a warp's fetch takes on average with the dense slab,
# random rows: each lane's 4 reads fall in its 4 banks 8 (q mod 4) + l, so a
# warp waits for the busiest of 8 such draws (about 2.96 expected).
MEAN_WAVEFRONTS_MAX = 3.1


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
    """The gather on the tool's random indices at the probe's width: the
    mean wavefronts a warp's fetch takes stays under the bound, one
    wavefront at best, and below the padded layout's."""
    tbl, idx = gp.gather_inputs(rows)
    idx = idx[:4096]  # 512 output rows a block: each thread's 4 rows live
    plan, _, conflicts = _hold(tbl, idx, 1, "none")
    mean = conflicts.mean()
    q = idx.reshape(-1, 4, 128)[:, :, :8].reshape(-1, 32)  # 4 rows x 8 lanes a warp
    spread = _spread_wavefronts(q, np.tile(np.arange(8), 4)[None, :])
    print(f"{plan.form}: {conflicts.size} warp fetches, {mean:.3f} wavefronts each on "
          f"average, {conflicts.max()} at most; the padded layout {spread.mean():.3f}")
    assert 1 <= conflicts.min() and mean <= MEAN_WAVEFRONTS_MAX
    assert mean < spread.mean()


# ---------------------------------------------------------------------------
# (d) The L2 line: the block body on the table in device memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,update,k", [
    (64, 64, "none", 1), (4096, 4096, "none", 1), (16384, 777, "none", 1),
    (1024, 333, "chain", 68), (16384, 100, "chain", 3), (4096, 99, "sweep", 5)])
def test_l2_line_equals_the_gather(rows, n, update, k):
    """``gather_chain_l2`` computes ``gather_chain``'s function (on a CPU
    tensor both run the plain version and launch nothing), == numpy and
    the JAX bodies."""
    rng = np.random.RandomState(rows + n + k)
    tbl = rng.randint(0, min(rows, 255) if update == "sweep" else rows,
                      (rows, gp.LF)).astype(np.int32)
    idx = rng.randint(0, rows, (n, gp.LF)).astype(np.int32)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    gp.build.reset_launch_counts()
    ours = gp.gather_chain_l2(t, i, k, update).numpy()
    assert not gp.build.LAUNCHES
    np.testing.assert_array_equal(ours, gp.gather_chain(t, i, k, update).numpy())
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
