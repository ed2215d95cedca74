"""Batched serving engine: a port of ``src/repro/serve/engine.py``
(``Request``, ``Completed``, ``ServeEngine.run``, ``_serve_batch`` and
``_sample``): fixed-slot batching over the model's prefill and decode
steps, with Froid-compiled admission (:mod:`.admission`) on the model's
device and greedy or temperature sampling.

Prompts are left-padded to the batch's longest and all rows share one
position counter, with no padding mask, as in the reference
(``engine.py:163-165``, ``transformer.py:284, 325``).  Sampling draws
from an explicit ``torch.Generator`` seeded from ``seed``: greedy is
``argmax``, temperature ``t`` samples ``softmax(logits / max(t, 1e-4))``.
It draws other tokens than ``jax.random.categorical`` from the same seed.

Two intake shapes, as in the reference:

* ``run(requests)`` — the whole wave arrives at once; admission evaluates
  it as one queue table (the tick path).
* ``submit(request)`` + ``drain()`` — requests arrive one at a time;
  ``drain`` tickets the queued wave on the coalescing scheduler, so
  admission runs as ``execute_many`` batches with the same queue depth
  (and therefore verdicts) as ``run``.  A ticket whose deadline passed, or
  whose degradation ladder ran out, completes as ``"shed"``.

``admission_fuse`` drains mixed-statement admission waves as one fused
wave; ``admission_store`` (a ``PlanStore`` or a path) warm-starts the
admission statement across engine restarts; ``admission_mesh`` shards the
online (``submit``/``drain``) admission batches over a device mesh
(:mod:`repro_torch.launch.mesh`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.resilience.faults import ResilienceError
from repro_torch.serve.admission import AdmissionPolicy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    tier: int = 1


@dataclasses.dataclass
class Completed:
    rid: int
    tokens: list
    reason: str  # length | eos | rejected | shed


class ServeEngine:
    def __init__(self, model, *, slots: int = 4, max_len: int = 256,
                 eos_id: int | None = None, froid_admission: bool = True,
                 admission_policy=None, seed: int = 0,
                 admission_scheduler=None, admission_mesh=None,
                 admission_fuse: bool = False, admission_adaptive: bool = False,
                 admission_timeout_s: float | None = None,
                 admission_store=None):
        self.model = model
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.admission = AdmissionPolicy(
            froid=froid_admission, policy=admission_policy, device=self.device,
            scheduler=admission_scheduler, mesh=admission_mesh,
            fuse=admission_fuse, adaptive=admission_adaptive,
            timeout_s=admission_timeout_s, store=admission_store,
        )
        self.shed: list[Completed] = []  # resilience-shed completions
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # online intake: requests awaiting the next drain()
        self._submitted: list[Request] = []

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]) -> list[Completed]:
        """Serve a request list to completion (batched, slot-filled)."""
        verdict = self.admission.evaluate(
            {
                "tier": np.array([r.tier for r in requests]),
                "prompt_len": np.array([len(r.prompt) for r in requests]),
                "max_new_tokens": np.array([r.max_new_tokens for r in requests]),
                "temperature": np.array([r.temperature for r in requests]),
            }
        )
        queue = []
        done: list[Completed] = []
        for i, r in enumerate(requests):
            if not verdict["admit"][i]:
                done.append(Completed(r.rid, [], "rejected"))
            else:
                queue.append((r, int(verdict["granted"][i]),
                              float(verdict["temp"][i])))

        while queue:
            batch = queue[: self.slots]
            queue = queue[self.slots :]
            done.extend(self._serve_batch(batch))
        return done

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Online intake: queue one request for the next ``drain()``."""
        self._submitted.append(request)

    def drain(self) -> list[Completed]:
        """Admit the queued wave set-oriented (per-request tickets on the
        coalescing scheduler, drained through ``execute_many``), then
        serve every admitted request to completion.  Admission happens at
        drain time so every ticket sees the same queue depth the tick path
        (``run``) would — identical verdicts, including load-shedding."""
        submitted, self._submitted = self._submitted, []
        depth = len(submitted)
        tickets = [
            self.admission.submit(
                tier=r.tier,
                prompt_len=len(r.prompt),
                max_new_tokens=r.max_new_tokens,
                temperature=r.temperature,
                depth=depth,
            )
            for r in submitted
        ]
        self.admission.scheduler.flush()
        queue = []
        done: list[Completed] = []
        for r, ticket in zip(submitted, tickets):
            try:
                v = AdmissionPolicy.verdict(ticket.result())
            except ResilienceError:
                # deadline shed / exhausted ladder: the request completes
                # explicitly instead of crashing the whole drain
                c = Completed(r.rid, [], "shed")
                self.shed.append(c)
                done.append(c)
                continue
            if not v["admit"]:
                done.append(Completed(r.rid, [], "rejected"))
            else:
                queue.append((r, v["granted"], v["temp"]))
        while queue:
            batch = queue[: self.slots]
            queue = queue[self.slots :]
            done.extend(self._serve_batch(batch))
        return done

    # ------------------------------------------------------------------
    def _serve_batch(self, batch) -> list[Completed]:
        B = len(batch)
        S = max(len(r.prompt) for r, _, _ in batch)
        toks = np.zeros((B, S), np.int32)
        for i, (r, _, _) in enumerate(batch):
            toks[i, S - len(r.prompt) :] = r.prompt  # left-pad
        budgets = np.array([b for _, b, _ in batch])
        temps = torch.tensor([t for _, _, t in batch], dtype=torch.float32,
                             device=self.device)

        logits, cache = self.model.prefill(
            torch.as_tensor(toks, device=self.device), max_len=self.max_len)
        outs: list[list[int]] = [[] for _ in range(B)]
        finished = np.zeros(B, bool)
        next_tok = self._sample(logits, temps)
        for i in range(B):
            outs[i].append(int(next_tok[i]))

        max_budget = int(budgets.max(initial=0))
        for step in range(1, max_budget):
            logits, cache = self.model.decode_step(
                cache, torch.as_tensor(next_tok, device=self.device)[:, None])
            next_tok = self._sample(logits, temps)
            for i in range(B):
                if finished[i]:
                    continue
                if step >= budgets[i]:
                    finished[i] = True
                    continue
                t = int(next_tok[i])
                outs[i].append(t)
                if self.eos_id is not None and t == self.eos_id:
                    finished[i] = True
            if finished.all():
                break

        out = []
        for i, (r, b, _) in enumerate(batch):
            reason = (
                "eos"
                if self.eos_id is not None and outs[i] and outs[i][-1] == self.eos_id
                else "length"
            )
            out.append(Completed(r.rid, outs[i][:b], reason))
        return out

    def _sample(self, logits, temps) -> np.ndarray:
        """Next tokens (B,) int32 on the host."""
        greedy = logits.argmax(dim=-1)
        probs = torch.softmax(logits / temps.clamp_min(1e-4)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        pick = torch.where(temps > 0, sampled, greedy)
        return pick.to(torch.int32).cpu().numpy()
