"""SmallBank and TATP (paper §10.2): the port against the reference, on
the CPU.

Each application runs ``run_mix`` as ``benchmarks/run.py``'s apps section
runs it (write share 1.0, seed 1; TATP populated first), and at a 0.5
write share, under the variants that section measures, ``sym``, ``naive``,
``r`` and ``rc``, through ``repro.core.apps`` and ``repro_torch.core.apps``
(blades on the CPU).  Balances and lookups, the arena's and the mirror's
digests, both clocks and both Stats must be equal.  The sizes are
``tests/test_apps.py``'s (200 accounts, 200 subscribers, 300 and 200
transactions) where the benchmark runs 50,000 accounts and 5,000
subscribers; the money-conservation and crash-recovery checks of that
file run through both packages too.
"""

import pytest

import _cluster_driver as drv
import _nvm_driver as nvm

VARIANTS = ("sym", "naive", "r", "rc")


def _fe(ns, variant, capacity=1 << 24):
    be = ns.core.NVMBackend(capacity=capacity, **ns.kw)
    return be, ns.core.FrontEnd(be, nvm.fe_config(ns.name, variant))


def _smallbank(variant, write_frac):
    def run(ns):
        be, fe = _fe(ns, variant)
        sb = ns.apps.SmallBank(fe, "sb", n_accounts=200)
        for a in range(200):
            sb.deposit_checking(a, 1000 + a)
        fe.drain(sb.h)
        t0 = fe.clock.now
        sb.run_mix(300, write_frac=write_frac, seed=1)
        fe.drain(sb.h)
        balances = [sb.balance(a) for a in range(200)]
        return {"virtual_ns": fe.clock.now - t0, "balances": balances, **nvm.state(be, fe)}
    return run


def _tatp(variant, write_frac):
    def run(ns):
        be, fe = _fe(ns, variant)
        t = ns.apps.TATP(fe, "tp", n_subscribers=200)
        t.populate(200)
        t0 = fe.clock.now
        t.run_mix(200, write_frac=write_frac, seed=1)
        t.drain()
        lookups = [(t.get_subscriber_data(s), t.get_access_data(s),
                    t.get_new_destination(s, s % 4, s % 24)) for s in range(0, 200, 3)]
        return {"virtual_ns": fe.clock.now - t0, "lookups": lookups,
                "forwarding": sorted(t.call_fwd.items()), **nvm.state(be, fe)}
    return run


@pytest.mark.parametrize("write_frac", [1.0, 0.5])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("app", ["smallbank", "tatp"])
def test_app_mix_matches_reference(app, variant, write_frac):
    runs = drv.both((_smallbank if app == "smallbank" else _tatp)(variant, write_frac))
    drv.assert_same(runs)
    assert runs["repro_torch"]["virtual_ns"] > 0


def _conservation(ns):
    be, fe = _fe(ns, "rc")
    sb = ns.apps.SmallBank(fe, "sb", n_accounts=100)
    for a in range(100):
        sb.deposit_checking(a, 1000)
    fe.drain(sb.h)
    total0 = sum(sb.balance(a) for a in range(100))
    sb.send_payment(1, 2, 300)
    sb.amalgamate(3, 4)
    sb.transact_savings(5, 77)
    sb.write_check(6, 10)
    fe.drain(sb.h)
    total1 = sum(sb.balance(a) for a in range(100))
    return {"totals": (total0, total1), "b": (sb.balance(3), sb.balance(4)), **nvm.state(be, fe)}


def _recovery(ns):
    be = ns.core.NVMBackend(capacity=1 << 24, **ns.kw)
    fe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(batch_ops=16, oplog_group=4))
    sb = ns.apps.SmallBank(fe, "sb", n_accounts=50)
    for a in range(50):
        sb.deposit_checking(a, 100)
    fe2 = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(), fe_id=1)
    sb2 = ns.apps.SmallBank.recover(fe2, "sb")
    return {"balances": [sb2.balance(a) for a in range(50)], **nvm.state(be, fe2)}


def _tatp_transactions(ns):
    be, fe = _fe(ns, "naive")
    t = ns.apps.TATP(fe, "t", n_subscribers=200)
    t.populate(200)
    trace = [t.get_subscriber_data(5)]
    t.update_location(5, 999)
    t.drain()
    trace.append(t.subscriber.find(5))
    t.insert_call_forwarding(5, 1, 8, 12345)
    t.drain()
    trace.append(t.get_new_destination(5, 1, 8))
    t.delete_call_forwarding(5, 1, 8)
    t.drain()
    trace.append(t.get_new_destination(5, 1, 8))
    return {"trace": trace, **nvm.state(be, fe)}


def test_smallbank_conservation_matches_reference():
    runs = drv.both(_conservation)
    drv.assert_same(runs)
    total0, total1 = runs["repro_torch"]["totals"]
    assert total1 == total0 + 77 - 10 and runs["repro_torch"]["b"] == (0, 2000)


def test_smallbank_crash_recovery_matches_reference():
    runs = drv.both(_recovery)
    drv.assert_same(runs)
    assert sum(runs["repro_torch"]["balances"]) >= 48 * 100


def test_tatp_transactions_match_reference():
    runs = drv.both(_tatp_transactions)
    drv.assert_same(runs)
    assert runs["repro_torch"]["trace"][1:] == [999, 12345, None]
