"""The closed loop: ``clients`` clients, each sending its next request as
soon as its previous one completes.  The engine's ticks then depend only
on the requests, never on the clock, so the ramp before the window
(``ramp_ticks``) is the same work in every run of a seed."""
from __future__ import annotations

from perfbench.harness.loop import EngineLoop


class Loop(EngineLoop):

    def start(self) -> None:
        for _ in range(int(self.mix["clients"])):
            if not self.send():
                raise RuntimeError(f"the engine refused request "
                                   f"{self.sent - 1}")

    def _on_done(self, n: int) -> None:
        for _ in range(n):
            if not self.send():
                raise RuntimeError(f"the engine refused request "
                                   f"{self.sent - 1}")
