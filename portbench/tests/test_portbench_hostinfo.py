"""The host readings on each run's info line: JSON-ready, and None where
the machine offers nothing to read."""

import json

from portbench import hostinfo


def test_readings_are_json_and_window_is_a_difference():
    a = hostinfo.snapshot()
    sum(range(100000))
    b = hostinfo.snapshot()
    got = hostinfo.window(a, b)
    json.dumps([hostinfo.placement(), got])
    for k in ("pgfault", "self_minflt"):
        assert got.get(k, 0) >= 0
    share = got.get("cpu_share")
    assert share is None or abs(sum(share.values()) - 1) < 0.01


def test_probe_times_a_fixed_workload():
    got = hostinfo.probe()
    assert set(got) == {"touch_256mib_s", "gather_16m_s"}
    assert all(v > 0 for v in got.values())


def test_card_without_a_bus_id_reads_none():
    assert hostinfo.card_sysfs("[N/A]") == {"card_numa_node": None,
                                            "card_local_cpus": None}
    assert hostinfo.card_sysfs(None)["card_numa_node"] is None
