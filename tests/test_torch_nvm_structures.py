"""The port's simulator against the reference: Table 3's cells on the CPU.

Each of Table 3's 44 cells (the eight remote structures under the six
front-end variants, less ``benchmarks/table3_throughput.py``'s SKIP) runs
the same seeded preload and op stream through ``repro.core`` and
``repro_torch.core`` (blades on the CPU), at write shares 1.0 (Table 3's
workload) and 0.5.  The arena and the mirror's, both clocks, both Stats,
the cache's counts, every op's result and the structure's contents must be
equal: the port's blade keeps its arena in a torch tensor and replays logs
through the kernels' plain versions, and none of that may move a byte or a
virtual nanosecond.  Table 3 runs 30000 preloaded keys and 3000 ops; here
300 and 100, on 4 MB blades.
"""

import pytest

import _nvm_driver as drv

PRELOAD, N_OPS = 300, 100


@pytest.mark.parametrize("write_frac", [1.0, 0.5])
@pytest.mark.parametrize("structure,variant", drv.CELLS)
def test_table3_cell_matches_reference(structure, variant, write_frac):
    runs = {}
    for pkg in drv.PACKAGES:
        be, fe, obj, keys, results = drv.run_cell(pkg, structure, variant, PRELOAD, N_OPS,
                                                  write_frac)
        st = drv.state(be, fe)
        st["results"] = results
        st["contents"] = drv.contents(obj, structure, keys)
        st["after"] = drv.state(be, fe)  # reading the contents moves the same bytes too
        runs[pkg] = st
    ref, port = runs["repro"], runs["repro_torch"]
    assert port["arena"] == ref["arena"]
    assert port["mirrors"] == ref["mirrors"]
    for key in ("blade_clock", "fe_clock", "blade_stats", "fe_stats", "cache", "results",
                "contents", "after"):
        assert port[key] == ref[key], key
    assert len(ref["contents"]) > 0
