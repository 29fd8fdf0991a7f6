"""Twin of ``tests/test_serving_admission.py`` on the port (indexes on the CPU).

Per-tenant admission control: token-bucket semantics under an injected
clock (refill, burst cap, zero-quota and single-slot edge cases), fairness
under an over-subscribed open loop (every tenant makes its quota-rate
progress — no starvation — and the shed load lands in the per-tenant obs
counters), and the ContinuousBatcher integration: bounded-queue rejection
at the door and the per-tenant queue-wait histogram.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro_torch import obs
from repro_torch.serving.scheduler import (AdmissionController, ContinuousBatcher,
                                     Request, TenantQuota)


def _count(name):
    return obs.counter(name).value


class TestTokenBucket:
    def test_burst_then_refill(self):
        adm = AdmissionController({"t": TenantQuota(rate=1.0, burst=2.0)})
        assert adm.try_admit("t", now=0.0)
        assert adm.try_admit("t", now=0.0)          # burst of 2 spent
        assert not adm.try_admit("t", now=0.0)
        assert not adm.try_admit("t", now=0.5)      # only 0.5 refilled
        assert adm.try_admit("t", now=1.6)          # 0.5 + 1.1 >= 1
        assert not adm.try_admit("t", now=1.7)

    def test_refill_caps_at_burst(self):
        adm = AdmissionController({"t": TenantQuota(rate=100.0, burst=2.0)})
        assert adm.try_admit("t", now=0.0)
        # a long idle gap refills to burst, not rate x elapsed
        for now in (100.0, 100.0):
            assert adm.try_admit("t", now=now)
        assert not adm.try_admit("t", now=100.0)

    def test_zero_quota_always_rejected(self):
        obs.reset()
        adm = AdmissionController({"z": TenantQuota(rate=0.0, burst=0.0)})
        for now in (0.0, 10.0, 1e6):
            assert not adm.try_admit("z", now=now)
        assert _count("serving.tenant.z.rejected") == 3
        assert _count("serving.admission.rejected") == 3

    def test_single_slot_admits_exactly_once(self):
        adm = AdmissionController({"s": TenantQuota(rate=0.0, burst=1.0)})
        got = [adm.try_admit("s", now=float(i)) for i in range(5)]
        assert got == [True, False, False, False, False]

    def test_unknown_tenant_without_default_is_admitted(self):
        obs.reset()
        adm = AdmissionController({"t": TenantQuota(rate=0.0, burst=1.0)})
        for _ in range(4):
            assert adm.try_admit("anon", now=0.0)
        assert _count("serving.tenant.anon.admitted") == 4

    def test_unknown_tenant_with_default_gets_own_bucket(self):
        adm = AdmissionController(
            {}, default_quota=TenantQuota(rate=0.0, burst=1.0))
        assert adm.try_admit("a", now=0.0)
        assert not adm.try_admit("a", now=1.0)
        # b's bucket is independent of a's spend
        assert adm.try_admit("b", now=1.0)


class TestFairness:
    def test_oversubscribed_open_loop_no_starvation(self):
        """Two equal-quota tenants each offering 2x their rate, plus a
        zero-quota tenant: each quota'd tenant makes quota-rate progress
        (neither is starved by the other's pressure), the zero-quota
        tenant never gets through, and the shed load is visible in the
        per-tenant obs counters."""
        obs.reset()
        adm = AdmissionController({"a": TenantQuota(rate=10.0, burst=1.0),
                                   "b": TenantQuota(rate=10.0, burst=1.0),
                                   "z": TenantQuota(rate=0.0, burst=0.0)})
        admitted = {"a": 0, "b": 0, "z": 0}
        # open loop: every 0.05 s each tenant offers one request (20 QPS
        # offered against a 10 QPS quota) for 2 simulated seconds
        for step in range(40):
            now = step * 0.05
            for t in ("a", "b", "z"):
                if adm.try_admit(t, now=now):
                    admitted[t] += 1
        assert admitted["z"] == 0
        # ~ rate x duration = 20 each (fp refill rounding can shave a
        # few); equal quotas must make near-equal progress
        for t in ("a", "b"):
            assert 15 <= admitted[t] <= 22, admitted
        assert abs(admitted["a"] - admitted["b"]) <= 1
        for t in ("a", "b"):
            assert _count(f"serving.tenant.{t}.rejected") >= 18
        assert _count("serving.admission.admitted") == (
            admitted["a"] + admitted["b"])


class TestBatcherIntegration:
    def _req(self, rid, tenant="default"):
        return Request(rid, np.array([1, 2, 3], np.int32),
                       max_new_tokens=2, tenant=tenant)

    def test_bounded_queue_rejects_at_the_door(self):
        obs.reset()
        b = ContinuousBatcher(1, max_queue=2)
        assert b.submit(self._req(0, "acme"))
        assert b.submit(self._req(1, "acme"))
        r = self._req(2, "acme")
        assert not b.submit(r)
        assert r.done and r.generated == []
        assert _count("serving.rejected_queue_full") == 1
        assert _count("serving.tenant.acme.rejected") == 1
        assert 2 not in b.requests       # shed, not queued

    def test_admission_reject_at_submit(self):
        obs.reset()
        adm = AdmissionController({"z": TenantQuota(rate=0.0, burst=0.0)})
        b = ContinuousBatcher(2, admission=adm)
        r = self._req(0, "z")
        assert not b.submit(r)
        assert r.done
        assert _count("serving.rejected") == 1
        assert _count("serving.tenant.z.rejected") == 1
        ok = self._req(1, "vip")         # no quota registered: admitted
        assert b.submit(ok)
        assert 1 in b.requests

    def test_queue_wait_histogram_per_tenant(self):
        obs.reset()
        b = ContinuousBatcher(2)
        b.submit(self._req(0, "acme"))
        b.submit(self._req(1, "umbrella"))
        b.admit()
        for t in ("acme", "umbrella"):
            h = obs.registry().histogram(f"serving.tenant.{t}.queue_wait")
            assert h.count == 1
        assert obs.registry().histogram("serving.queue_wait").count == 2
