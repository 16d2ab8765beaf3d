"""The simulator's figures beyond Table 3: the port against the reference,
bit for bit, on the CPU.

Each test runs one scenario of ``tests/_sim_driver.py`` through ``repro``
(the reference) and ``repro_torch`` (the port, its blades on the CPU) and
holds everything the run leaves equal: sha256 of every arena and mirror,
the blade and front-end clocks, Stats, cache counts, every op's result and
the figure's rows without wall-clock fields.  Sizes are
``benchmarks/run.py --smoke``'s: preload 400, 120 ops (128 for the vector
rows, as run.py gives them), 64 MB blades as the scripts make them.

- Fig 9 (SWMR): the lock-based BST under the writer-preferred seqlock
  against the multi-version BST, 1 and 6 readers.
- Vector ops: serial against ``*_many`` batches on the four structures,
  the cross-structure ``batch_all`` window (one combined flush), the
  4-blade cluster row.
- Figs 7, 8, 12: batches 1 and 1024, cache fractions 0.10 and 1.0, write
  fractions 1.0 and 0.5.
- Table 2: the RPC allocator and the two-tier one with slabs 128 and 1024,
  1500 allocations and frees.
- Fig 11: no replication, a blade mirror, replication driven by the front
  end.
"""

import pytest

import _sim_driver as drv

PRELOAD, OPS = drv.SMOKE
VECTOR_OPS = max(OPS, 128)  # benchmarks/run.py gives the vector rows max(n_ops, 128)


@pytest.mark.parametrize("readers", [1, 6])
@pytest.mark.parametrize("mode", ["lock", "mv"])
def test_fig9_swmr_matches_reference(mode, readers):
    port = drv.assert_same(drv.both(drv.fig9, mode, readers, PRELOAD, OPS, OPS))
    row, (_, state) = port["rows"], port["steps"][0]
    assert len(state["readers"]) == readers
    assert all(len(r) == OPS for r in state["reader_results"])
    if mode == "lock":  # readers retry under write pressure; the closing reads are clean
        assert row["retry_frac"] > 0
        assert len(state["consistent_reads"]) == readers * drv.CONSISTENT_READS
        assert all(v is not None for v in state["consistent_reads"])
    else:  # a pinned snapshot never retries, and every preloaded key is found
        assert row["retry_frac"] == 0.0
        assert all(v is not None for r in state["reader_results"] for v in r)


def test_fig9_mv_readers_beat_lock_readers():
    """The figure's headline at 6 readers, the same in both packages."""
    rows = {mode: drv.assert_same(drv.both(drv.fig9, mode, 6, PRELOAD, OPS, OPS))["rows"]
            for mode in ("lock", "mv")}
    assert rows["mv"]["reader_kops_avg"] > rows["lock"]["reader_kops_avg"]


@pytest.mark.parametrize("structure", drv.VECTOR_STRUCTURES)
def test_vector_structure_matches_reference(structure):
    port = drv.assert_same(drv.both(drv.vector_structure, structure, PRELOAD, VECTOR_OPS))
    assert port["rows"]["put_speedup"] > 1.0
    serial, batched = (state for _, state in port["steps"])
    got = serial["gets"] + [v for batch in batched["gets"] for v in batch]
    assert len(got) == 2 * VECTOR_OPS and None not in got  # every read is of a preloaded key


def test_vector_cross_structure_batch_all_matches_reference():
    port = drv.assert_same(drv.both(drv.vector_cross_structure, PRELOAD, VECTOR_OPS))
    serial, batched = (state for _, state in port["steps"])
    assert batched["fe"]["stats"]["combined_flushes"] > serial["fe"]["stats"]["combined_flushes"]
    assert batched["read_back"] == serial["read_back"]
    assert port["rows"]["put_speedup"] > 1.0


def test_vector_cluster_matches_reference():
    port = drv.assert_same(drv.both(drv.vector_cluster, PRELOAD, VECTOR_OPS))
    serial, batched = (state for _, state in port["steps"])
    assert len(batched["cluster"]["blades"]) == 4
    assert batched["read_back"] == serial["read_back"] == list(range(VECTOR_OPS))


@pytest.mark.parametrize("fig", ["fig7", "fig8", "fig12"])
def test_sweeps_match_reference(fig):
    port = drv.assert_same(drv.both(drv.sweeps, PRELOAD, OPS, figs=(fig,), **drv.SWEEPS))
    assert set(port["rows"]) == {fig}
    if fig == "fig7":  # group commit of 1024 ops beats one op a commit
        assert all(row[1024] > row[1] for row in port["rows"]["fig7"].values())


def test_table2_allocators_match_reference():
    port = drv.assert_same(drv.both(drv.table2))
    rows = port["rows"]
    assert rows["two-tier-1024"][0] > rows["two-tier-128"][0] > rows["rpc"][0]
    slabs = {name: state["blade"] for name, state in port["steps"]}
    assert slabs["two-tier-128"]["arena"] != slabs["two-tier-1024"]["arena"]


def test_fig11_replication_matches_reference():
    port = drv.assert_same(drv.both(drv.fig11, PRELOAD, OPS))
    states = dict(port["steps"])
    assert states["blade_rep"]["blade"]["mirrors"] == [states["blade_rep"]["blade"]["arena"]]
    assert states["no_rep"]["blade"]["mirrors"] == []
    assert port["rows"]["overhead_fe"] > port["rows"]["overhead_blade"]
