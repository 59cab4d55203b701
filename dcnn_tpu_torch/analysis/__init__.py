"""Capture-safety & concurrency static-analysis suite of the port.

``python -m dcnn_tpu_torch.analysis`` runs the AST-based check families
over the live package (``dcnn_tpu_torch`` by default) and exits non-zero
on any unsuppressed finding; the port's tier-1 test
(``tests/test_torch_analysis.py``) holds it at zero. It is the JAX
package's suite (``dcnn_tpu.analysis``), with its trace-safety family
re-aimed at CUDA graph capture, and imports nothing of that package:

========  ===================  ==============================================
check id  name                 what it catches
========  ===================  ==============================================
TS01      capture-host-sync    ``.item()``/``.cpu()``/``synchronize()`` in
                               code a CUDA graph captures
TS02      capture-host-cast    ``float()``/``int()``/``bool()`` on tensors
                               there
TS03      capture-print        ``print()`` there (runs at capture only)
TS04      global-rng           global RNG state / draws without
                               ``generator=`` in determinism-contract modules
TS05      capture-impure       Python-side writes there (capture only)
TS06      recapture            sessions built per call, in loops, or
                               cached under per-call keys
CC01      guarded-by           unannotated / unlocked cross-thread attribute
CC02      thread-lifecycle     threads neither joined nor daemon+finalizer
CC03      resource-lifecycle   shm/HTTP-server/pool without context manager
                               or ``__del__``
AT01      atomic-commit        bare ``open(w)``/``np.save`` on commit paths
DL01      lock-order           cycles in the package's lock order
DL02      blocking-under-lock  blocking IO while a lock is held
PR01      frame-unhandled      a sent frame no handler has an arm for
PR02      unfenced-stamp       a gen/nonce-stamped frame its handler never
                               compares
========  ===================  ==============================================

Suppression: append ``# dcnn: disable=<check-id>`` to the offending line
(with a justification comment), or record the finding's stable key in
``dcnn_tpu_torch/analysis/baseline.json``. Lock annotations for CC01 use
``# dcnn: guarded_by=<lock-attr>`` on the attribute's ``__init__``
assignment. The annotation grammar is the JAX suite's, letter for letter,
so one annotation serves both tools.
"""

from .core import (Baseline, Finding, all_checks, analyze_paths,
                   load_project, unsuppressed, DEFAULT_BASELINE)

__all__ = ["Baseline", "Finding", "all_checks", "analyze_paths",
           "load_project", "unsuppressed", "DEFAULT_BASELINE"]
