"""device: ``device_idle.solve``'s reader, for the cells whose end-to-end metric
it moves differs."""
import pathlib

from bench.harness import load_module

read = load_module(pathlib.Path(__file__).with_name("device_idle.solve.py")).read
