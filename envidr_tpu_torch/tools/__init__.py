"""The hash-table gather/scatter micro-benchmarks of the JAX package's
``tools/`` (``bench_scatter.py``, ``bench_scatter2.py``, ``bench_gs4.py``),
ported to the card.

Each module runs as ``python -m envidr_tpu_torch.tools.<name>`` on the CUDA
card, prints one row per strategy under the JAX script's row names
(``name  ms  Mrows/s  GB/s``) and ends with a JSON summary.  Each XLA row
becomes its nearest single PyTorch call; each Pallas row launches its
hand-written counterpart (``ops/gather.py``, ``ops/scatter.py``).  The
defaults are the scripts' full shapes; ``main(argv, device="cpu")`` runs
the plain versions on the CPU at the shapes given.
"""
