"""DTD insertion linter: the dynamic-path counterpart of ptc-verify.

Port of parsec_tpu/analysis/dtdlint.py (it has no JAX; the rules, their
IDs and messages are the reference's).

PTG graphs are verified before execution (analysis.verify); a DTD
graph only exists as it is inserted, so the linter rides insertion.
Opt-in via `DtdTaskpool(ctx, lint=True)` (or lint="warn" to report
instead of raise).  Rules carry stable IDs like the V-rules:

  D101  undeclared access-mode conflict: the same tile passed twice to
        one task with modes that overlap in a write (e.g. INPUT +
        OUTPUT as separate arguments).  The native accessor chain
        orders the two flows arbitrarily — declare one INOUT argument
        instead.
  D102  use-after-finalize: a task inserted against a tile whose
        owning taskpool already ran wait()/destroy() — the accessor
        chain is gone and the insert dangles.
  D103  dead store (reported at wait()): a tile whose LAST access is
        OUTPUT with no later reader in the pool — the write is never
        observed through the dataflow (warning; the backing memory
        still holds it).
  D104  tile/arena stride mismatch: an inserted tile whose backing
        data's byte size disagrees with its collection's declared
        stride (mb x nb x itemsize — what device staging and the
        arena-backed wire path assume).  Caught statically at insert,
        before the runtime truncates or over-reads the payload.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

DTD_RULES: Dict[str, str] = {
    "D101": "undeclared access-mode conflict in one task",
    "D102": "tile use after taskpool finalize",
    "D103": "dead store: OUTPUT tile never read afterwards",
    "D104": "tile byte size disagrees with its collection's stride",
}


class DtdLintError(RuntimeError):
    """Error-severity DTD lint finding (rule id in .rule)."""

    def __init__(self, rule: str, message: str):
        self.rule = rule
        super().__init__(f"{rule}: {message}")


class DtdLinter:
    """Per-taskpool insertion observer.  The DtdTaskpool calls
    `on_insert` before handing the task to the native engine,
    `on_wait` when the window closes, and `on_destroy` when tiles are
    freed; `findings` accumulates (rule, message) warnings."""

    def __init__(self, mode: str = "error"):
        # mode "error": raise DtdLintError on error-severity findings;
        # mode "warn": record everything in .findings only
        self.mode = mode
        self.findings: List[Tuple[str, str]] = []
        self._finalized = False
        self._task_no = 0
        # tile id -> (last mode, task_no of last access, reads seen
        #             since last write)
        self._tiles: Dict[int, list] = {}
        self._names: Dict[int, str] = {}

    # ---------------------------------------------------------- events
    def _emit(self, rule: str, severity: str, message: str):
        self.findings.append((rule, message))
        if severity == "error" and self.mode != "warn":
            raise DtdLintError(rule, message)

    def _tname(self, tile) -> str:
        nm = self._names.get(id(tile))
        if nm is None:
            nm = f"tile#{len(self._names)}"
            self._names[id(tile)] = nm
        return nm

    def on_insert(self, args):
        """args: sequence of (tile, mode_int) the task was declared
        with (modes already normalized to INPUT=1/OUTPUT=2/INOUT=3)."""
        self._task_no += 1
        if self._finalized:
            self._emit(
                "D102", "error",
                f"task #{self._task_no} inserted after the taskpool "
                "was finalized (wait() already closed the window): "
                "the dependency chains it would attach to are gone")
            return
        seen: Dict[int, int] = {}
        for tile, mode in args:
            key = id(tile)
            st = self._tiles.get(key)
            stride = getattr(tile, "coll_stride", None)
            nbytes = getattr(tile, "nbytes", None)
            if st is None and stride is not None and nbytes is not None \
                    and nbytes != stride:
                # first sight of the tile: its data size must match the
                # collection's declared stride, or the runtime's staging
                # and wire paths truncate or over-read the payload
                self._emit(
                    "D104", "error",
                    f"task #{self._task_no}: {self._tname(tile)} backs "
                    f"{nbytes} B but its collection declares a "
                    f"{stride} B tile stride — device staging and the "
                    "arena-backed wire path move stride-sized "
                    "payloads, so this tile would be truncated or "
                    "over-read; fix the collection's tile allocation "
                    "(or its declared mb/nb/dtype)")
            if getattr(tile, "_lint_finalized", False):
                self._emit(
                    "D102", "error",
                    f"task #{self._task_no} uses {self._tname(tile)} "
                    "from a destroyed taskpool: its accessor chain was "
                    "freed (use-after-finalize)")
            if key in seen:
                if (seen[key] | mode) & 2 and seen[key] != mode:
                    self._emit(
                        "D101", "error",
                        f"task #{self._task_no} passes "
                        f"{self._tname(tile)} twice with conflicting "
                        f"modes ({seen[key]} and {mode}): the two "
                        "flows order arbitrarily in the accessor "
                        "chain — declare one INOUT argument instead")
                seen[key] |= mode
            else:
                seen[key] = mode
            if st is None:
                st = self._tiles[key] = [0, 0, 0, tile]
            st[0] = mode
            st[1] = self._task_no
            if mode & 1:
                st[2] += 1  # read since last write ...
            if mode & 2 and not (mode & 1):
                st[2] = 0  # ... pure write resets the reader count

    def on_wait(self):
        if self._finalized:
            return
        self._finalized = True
        for key, (mode, _task, nreads, tile) in self._tiles.items():
            if mode == 2 and nreads == 0:
                self._emit(
                    "D103", "warning",
                    f"{self._tname(tile)}: last access is OUTPUT with "
                    "no later reader in this pool — dead store through "
                    "the dataflow (drop the task or read the result)")

    def on_destroy(self):
        self._finalized = True
        for st in self._tiles.values():
            tile = st[3]
            try:
                tile._lint_finalized = True
            except AttributeError:
                pass
