"""The self-healing training runtime (docs/DESIGN.md §8–§9): the loss and
skip guard, the hang watchdog, the data blocklist, the fault supervisor
and the checkpoint writer processes.

Counterpart of ``repro/runtime/``.  ``guard.py`` and ``fault.py`` are
plain Python; ``procs.py`` uses numpy and ``checkpoint/wire.py`` only,
so a writer process never loads torch."""
