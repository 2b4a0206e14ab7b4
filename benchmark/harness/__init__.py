"""The benchmark's general machinery: the manifest, clocks and spans, the
device trace, the peaks and operation counts, weights and inputs made
from the seed, and the comparison that decides `correct`."""
