"""convergence engine: ``passes_per_solve``'s reader, for the cells whose end-to-end metric
it moves differs."""
import pathlib

from bench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("passes_per_solve.py")).read
