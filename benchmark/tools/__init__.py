"""A tool that runs on the card beside the benchmark: the readings the
output limits are set from (`calibrate`). The benchmark's own runs do
not use it."""
