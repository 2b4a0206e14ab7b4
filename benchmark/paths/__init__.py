"""The drivers of the port's timed paths, one module a path; a traffic
file names its driver under "path". A driver is built with
(cell, seed, device, spans), which is the run's set-up, and then gives

- `window(seconds, spans)` → a `Window`: the timed loop, ended by a
  synchronise;
- `end_to_end(window)` → {metric: value} of the cell's end-to-end
  metrics;
- `release()`: keeps what the check compares and frees the program's
  state, once the peak memory is read;
- `readings(candidate)` → {number: value}: the numbers that decide
  `correct`, of the program ("program") or of the control ("control")
  against the plain reference; the limits are `limits/<cell>.json`.
"""

import dataclasses


@dataclasses.dataclass
class Window:
    t0: float                 # host perf_counter at the first timed step
    t1: float                 # after the closing synchronise
    work: dict                # counts: images, batches, requests, steps
    launches: dict            # the port's launch counters over the window
    attempted: int
    failed: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0
