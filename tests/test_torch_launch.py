"""The launch-plan seam of the port's kernels (rrrmc_tpu_torch/ops/launch.py)
on the CPU, with a fake library whose C entries count their calls: an
instantiation's facts are asked once per key, a card's SM count and shared
memory once per device; the last plan and the launches are kept per
kernel name; and every kernel's plan rule refuses a chain that does not
fit in shared memory with the one message of `require_smem`."""

import collections
import re

import pytest
import torch

from rrrmc_tpu_torch.ops import cuda_build, launch
from rrrmc_tpu_torch.ops.eo import eo_plan
from rrrmc_tpu_torch.ops.eo_perc import eo_perc_plan
from rrrmc_tpu_torch.ops.rejfree import fused_plan
from rrrmc_tpu_torch.ops.sweep import sweep_plan

#: the message every refusal gives
REFUSAL = (r"the .+ kernel keeps a chain's state in shared memory: "
           r"N=\d+ needs \d+ bytes, a block may have \d+")


class FakeLibrary:
    """C entries that record each call's arguments: an info entry fills
    out[5] from its arguments, a max_smem entry returns 1000 + device."""

    def __init__(self):
        self.calls = []

    def fake_info(self, *args):
        *head, device, out = args
        self.calls.append(("info", tuple(head), device))
        for k in range(5):
            out[k] = sum(head) + k
        return 0

    def fake_max_smem(self, device):
        self.calls.append(("max_smem", device))
        return 1000 + device


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLibrary()
    monkeypatch.setattr(cuda_build, "library", lambda: fake)
    for f in (launch.facts, launch.sm_count, launch.max_smem):
        f.cache_clear()
    yield fake
    for f in (launch.facts, launch.sm_count, launch.max_smem):
        f.cache_clear()


def test_facts_asked_once_per_key(lib):
    """The entry sees (threads, *head, need, device) once per key; a new
    key asks again; the facts are what the entry wrote."""
    f = launch.facts("fake_info", (2, 3), 256, 4096, 0)
    assert f == tuple(256 + 2 + 3 + 4096 + k for k in range(5))
    for _ in range(3):
        assert launch.facts("fake_info", (2, 3), 256, 4096, 0) == f
    assert lib.calls == [("info", (256, 2, 3, 4096), 0)]
    launch.facts("fake_info", (2, 3), 512, 4096, 0)
    launch.facts("fake_info", (2, 3), 256, 4096, 1)
    assert lib.calls[1:] == [("info", (512, 2, 3, 4096), 0),
                             ("info", (256, 2, 3, 4096), 1)]


def test_facts_without_threads_or_need(lib):
    """An entry that takes no thread count (the class kernel's) or no
    dynamic bytes is called without them."""
    launch.facts("fake_info", (), None, 700, 0)
    launch.facts("fake_info", (5, 1), None, None, 0)
    assert lib.calls == [("info", (700,), 0), ("info", (5, 1), 0)]


def test_info_hands_a_rule_the_facts(lib):
    """info(entry, head, device) is the rules' info(T, need): a plan made
    twice asks each instantiation once."""
    info = launch.info("fake_info", (1,), 0)
    plans = [fused_plan("k", info, 128, 10_000, 64, torch.int8, 132)
             for _ in range(2)]
    assert plans[0] == plans[1]
    assert sorted(lib.calls) == [("info", (256, 1, 64), 0),
                                 ("info", (512, 1, 64), 0)]


def test_card_facts_asked_once_per_device(lib, monkeypatch):
    """The SM count and the most shared bytes a block may opt in to are
    asked once per device."""
    asked = []

    class Props:
        multi_processor_count = 132

    def props(device):
        asked.append(device)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    assert [launch.sm_count(d) for d in (0, 0, 1, 0, 1)] == [132] * 5
    assert asked == [0, 1]
    assert [launch.max_smem("fake_max_smem", d)
            for d in (0, 1, 0, 1)] == [1000, 1001, 1000, 1001]
    assert lib.calls == [("max_smem", 0), ("max_smem", 1)]


def test_plans_and_launches_by_kernel(monkeypatch):
    """record keeps the last plan of each kernel apart from the others;
    launched counts each kernel apart, and raises on a failed launch
    without counting it."""
    monkeypatch.setattr(launch, "PLANS", {})
    monkeypatch.setattr(launch, "LAUNCHES", collections.Counter())
    a, b = {"threads": 256}, {"warps": 4}
    assert launch.record("rejfree_sparse", a) is a
    launch.record("eo_sparse", b)
    launch.record("rejfree_sparse", {"threads": 512})
    assert launch.PLANS == {"rejfree_sparse": {"threads": 512},
                            "eo_sparse": b}
    for name in ("site", "site", "sweep"):
        launch.launched(name, 0)
    with pytest.raises(RuntimeError, match="sweep launch: CUDA error 700"):
        launch.launched("sweep", 700)
    assert launch.LAUNCHES == {"site": 2, "sweep": 1}
    assert launch.LAUNCHES["eo_sparse"] == 0


def _no_room(t, need):
    """Facts of a card where a block may have 1000 dynamic bytes."""
    return (4 if need <= 1000 else 0, 64, 0, 0, 1000)


@pytest.mark.parametrize("rule", ["require_smem", "fused_plan", "sweep_plan",
                                  "eo_plan", "eo_perc_plan"])
def test_one_refusal(rule):
    """Every kernel's plan refuses a chain that does not fit with the
    message of require_smem."""
    call = {
        "require_smem": lambda: launch.require_smem(2000, 1000, 64, "site"),
        "fused_plan": lambda: fused_plan("rejfree_sparse", _no_room, 128,
                                         5000, 2000, torch.int8, 132),
        "sweep_plan": lambda: sweep_plan(
            5000, 64, 6, 132, lambda t, smem, swar: _no_room(t, smem)),
        "eo_plan": lambda: eo_plan(5000, 64, torch.int8, 13, 132, _no_room),
        "eo_perc_plan": lambda: eo_perc_plan(1023, 511, "step", _no_room),
    }[rule]
    with pytest.raises(NotImplementedError) as err:
        call()
    assert re.fullmatch(REFUSAL, str(err.value)), str(err.value)
