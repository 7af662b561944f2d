"""Rich table rendering for eval reports: the port's copy of
vision_kit_tpu/utils/table.py (tab-separated text without rich)."""

from __future__ import annotations


class RichTable:
    def __init__(self, title: str = ""):
        self.title = title
        self.headers: list = []
        self.rows: list = []

    def add_headers(self, headers):
        self.headers = list(headers)

    def add_content(self, rows):
        self.rows.extend(rows)

    @property
    def table(self) -> str:
        try:
            import io

            from rich.console import Console
            from rich.table import Table
        except ImportError:
            lines = ["\t".join(map(str, self.headers))]
            lines += ["\t".join(map(str, r)) for r in self.rows]
            return "\n".join(lines)
        t = Table(title=self.title)
        for h in self.headers:
            t.add_column(str(h))
        for row in self.rows:
            t.add_row(*[str(c) for c in row])
        buf = io.StringIO()
        Console(file=buf, width=120).print(t)
        return buf.getvalue()

    def print(self):
        print(self.table)
