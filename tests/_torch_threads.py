"""The port's CPU tests at bert-smoke size share one fixture: import
``one_cpu_thread`` by name into a test module to run that module's tensors
on one intra-op thread."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """bert-smoke's tensors are small: one intra-op thread runs them faster
    than many, and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
