"""
Per-tenant quotas for the survey service (the port's copy of the JAX
package's ``serve/tenants.py``).

Two independent limits, enforced at the service's two natural control
points:

* **max in-flight chunks** (admission control): a tenant may hold at
  most ``max_active`` jobs in the pending/running set. Because the
  fair-share queue grants one device turn at a time, each active job
  has at most one chunk in flight, so "max active jobs" IS "max
  in-flight chunks" under the one-card model; a submit over the
  limit is rejected with HTTP 429 and a ``job_rejected`` incident —
  never queued into starvation.
* **device-seconds budget** (runtime control): every device turn's
  wall seconds are charged against the tenant's budget (default
  ``RIPTIDE_SERVE_QUOTA_DEVICE_S``; 0 = unlimited); once exhausted,
  the tenant's jobs are stopped at their next chunk boundary with a
  ``quota_exceeded`` incident, journals left resumable — a budget
  top-up plus resubmit continues where the budget ran out.

Stdlib-only; thread-safe (the daemon's HTTP handler threads and job
workers all touch it).
"""
import threading

from ..utils import envflags

__all__ = ["TenantTable"]

# A tenant may keep this many jobs in the pending/running set unless
# configured otherwise (admission control; see module docstring).
DEFAULT_MAX_ACTIVE = 8


class TenantTable:
    """Quota state per tenant name.

    Parameters
    ----------
    budget_device_s : float or None
        Default device-seconds budget per tenant; ``None`` reads
        ``RIPTIDE_SERVE_QUOTA_DEVICE_S``. ``0`` means unlimited.
    max_active : int
        Max pending+running jobs per tenant (admission control).
    """

    def __init__(self, budget_device_s=None, max_active=DEFAULT_MAX_ACTIVE):
        if budget_device_s is None:
            budget_device_s = float(
                envflags.get("RIPTIDE_SERVE_QUOTA_DEVICE_S"))
        self.budget_device_s = float(budget_device_s)
        self.max_active = int(max_active)
        self._lock = threading.Lock()
        self._spent = {}     # tenant -> charged device seconds
        self._active = {}    # tenant -> active (pending+running) jobs
        self._budgets = {}   # tenant -> per-tenant budget override

    def set_budget(self, tenant, device_s):
        """Override one tenant's device-seconds budget (0 = unlimited)."""
        with self._lock:
            self._budgets[tenant] = float(device_s)

    def _budget(self, tenant):
        return self._budgets.get(tenant, self.budget_device_s)

    # -- admission -------------------------------------------------------

    def admit(self, tenant):
        """``(ok, reason)`` for accepting one more job from ``tenant``
        (checked at submit time, BEFORE the job is registered)."""
        with self._lock:
            if self._active.get(tenant, 0) >= self.max_active:
                return False, (
                    f"tenant {tenant!r} at max active jobs "
                    f"({self.max_active})")
            budget = self._budget(tenant)
            if budget > 0 and self._spent.get(tenant, 0.0) >= budget:
                return False, (
                    f"tenant {tenant!r} device-seconds budget exhausted "
                    f"({self._spent.get(tenant, 0.0):.3f}/{budget:.3f}s)")
            return True, None

    def job_started(self, tenant):
        with self._lock:
            self._active[tenant] = self._active.get(tenant, 0) + 1

    def job_finished(self, tenant):
        with self._lock:
            self._active[tenant] = max(0, self._active.get(tenant, 0) - 1)

    # -- runtime budget --------------------------------------------------

    def charge(self, tenant, device_s):
        with self._lock:
            self._spent[tenant] = self._spent.get(tenant, 0.0) \
                + float(device_s)

    def spent(self, tenant):
        with self._lock:
            return self._spent.get(tenant, 0.0)

    def exhausted(self, tenant):
        """True once the tenant's charged seconds meet its budget."""
        with self._lock:
            budget = self._budget(tenant)
            return budget > 0 and self._spent.get(tenant, 0.0) >= budget

    def remaining(self, tenant):
        """Seconds left in the budget, or None when unlimited."""
        with self._lock:
            budget = self._budget(tenant)
            if budget <= 0:
                return None
            return max(0.0, budget - self._spent.get(tenant, 0.0))

    def snapshot(self):
        """Per-tenant quota state for the /jobs listing."""
        with self._lock:
            names = set(self._spent) | set(self._active) | \
                set(self._budgets)
            out = {}
            for t in sorted(names):
                budget = self._budget(t)
                out[t] = {
                    "active_jobs": self._active.get(t, 0),
                    "device_s_spent": round(self._spent.get(t, 0.0), 6),
                    "device_s_budget": budget if budget > 0 else None,
                }
            return out
