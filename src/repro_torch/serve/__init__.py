"""Port of ``src/repro/serve``: the slot engine, Froid-compiled admission
and the coalescing scheduler (the fleet waits, ROADMAP A9)."""
from repro_torch.serve.admission import AdmissionPolicy
from repro_torch.serve.engine import Completed, Request, ServeEngine
from repro_torch.serve.scheduler import CoalescingScheduler, Ticket

__all__ = ["AdmissionPolicy", "CoalescingScheduler", "Completed", "Request",
           "ServeEngine", "Ticket"]
