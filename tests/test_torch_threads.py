"""The port's tests run torch's CPU operators on one thread.

The test lane (ROADMAP's tier-1 command) runs six pytest workers at once
on the host's cores. Each worker's torch would otherwise start one OpenMP
thread per core, and under that load a parallel region's barrier waits on
threads that the scheduler has parked. On an eight-core host, back to
back on one tree, the lane took 1,219 s with a thread per core and 550 s
with this setting; the test times summed 6,284 s and 2,595 s, C29's
microstep (``test_torch_mocha_rounding.py``) 287 s and 72 s. pytest
imports every test module of a run before it runs a test, so the
setting below holds for every test of the process. The JAX package's tests
compute in XLA's own thread pool, which it leaves as it is.
"""
import torch

torch.set_num_threads(1)


def test_torch_computes_on_one_thread_in_the_test_process():
    assert torch.get_num_threads() == 1
