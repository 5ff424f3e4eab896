"""ASCII table renderer (role of `_util/util_v1.py:369+` Table)."""

from __future__ import annotations

from typing import List, Sequence


class Table:
    def __init__(self, rows: Sequence[Sequence]):
        self.rows = [[str(c) for c in r] for r in rows]

    def __str__(self):
        if not self.rows:
            return ""
        ncol = max(len(r) for r in self.rows)
        widths = [0] * ncol
        for r in self.rows:
            for i, c in enumerate(r):
                widths[i] = max(widths[i], len(c))
        lines = []
        for ri, r in enumerate(self.rows):
            cells = [
                (c.ljust(widths[i]) if i == 0 else c.rjust(widths[i]))
                for i, c in enumerate(r)
            ]
            lines.append(" " + "  ".join(cells) + " ")
            if ri == 0:
                lines.append("=" * (sum(widths) + 2 * ncol + 1))
        return "\n".join(lines)
