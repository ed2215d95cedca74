"""Port of ``src/repro/loops/__init__.py`` (a copy on the port's plan layer).

Cursor/WHILE loop analysis and Aggify-style rewriting.

The pipeline stage between the imperative IR and the relational algebra:
``analysis.classify`` issues a :class:`~repro_torch.loops.analysis.LoopVerdict`
for every loop statement, and ``rewrite.compile_loop`` turns rewritable
cursor loops into a single :class:`repro_torch.core.relalg.LoopScan` operator
over the cursor's defining query.  Non-rewritable loops keep an explicit
verdict and fall back to the per-row interpreter (the correctness
oracle's reference semantics).
"""
from repro_torch.loops.analysis import LoopVerdict, classify, reduce_info
from repro_torch.loops.rewrite import compile_loop

__all__ = ["LoopVerdict", "classify", "reduce_info", "compile_loop"]
