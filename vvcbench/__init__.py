"""The benchmark of `ffmpeg_tpu_torch`, the PyTorch and CUDA port of the
VVC decoder, on NVIDIA H100 cards.

    python vvcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of the repository's `BENCHMARK.json` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix or
metric is a file found by its name:

- `configs/<config>.json`: the stream generator's keyword arguments and
  the public definition they stand for;
- `traffic/<mix>.json`: how many decode sessions share the card and how
  many parse lanes each has;
- `truth/<config>/<seed>.json`: a stream of the configuration's pool,
  with the MD5 of each of its frames as the JAX package decodes it
  (made on the CPU by `truth/make.py`, which nothing here runs);
- `end_to_end/<metric>.py` and `metrics/<metric>.py`: a `read(record)`
  each, which returns the metric's value or None.

The streams come from a frozen copy of the port's generator (`frozen/`),
whose bytes each run checks against the truth's sha256, and every frame
a window decodes is judged against the truth's MD5s, so that no later
change to the port moves the yardstick.  A frozen copy of the port's
plain decode path (`reference.py`) serves the control and stands as a
second witness.
"""
