"""Port of ``src/repro/serve``: the slot engine, Froid-compiled admission,
the coalescing scheduler and the multi-worker fleet."""
from repro_torch.serve.admission import AdmissionPolicy
from repro_torch.serve.engine import Completed, Request, ServeEngine
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.scheduler import CoalescingScheduler, Ticket

__all__ = ["AdmissionPolicy", "CoalescingScheduler", "Completed", "FleetEngine",
           "Request", "ServeEngine", "Ticket"]
