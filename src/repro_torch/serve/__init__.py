"""Port of ``src/repro/serve``: the slot engine and Froid-compiled
admission (the fleet and the coalescing scheduler wait, ROADMAP A6/A9)."""
from repro_torch.serve.admission import AdmissionPolicy
from repro_torch.serve.engine import Completed, Request, ServeEngine

__all__ = ["AdmissionPolicy", "Completed", "Request", "ServeEngine"]
