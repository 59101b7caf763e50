"""The dry-run's serving records on the two-pod production mesh
(``pod=2,data=16,model=16``, 512 ranks), a test each: every prefill,
decode and long-context record of ``full_plan()`` is ``ok`` or the
reference's skip (``…_1pod.py``: the one-pod mesh's).  Each traces rank
0's call as one rank of the static ``Engine`` on the mesh runs it: its
rows, its block of the cache (its kv heads, its ``inner`` slice, at batch
1 its block of positions under the reference's ``cache_seq`` rule) and
its parameter blocks.  xlstm-350m's ``prefill_32k`` traces at its 32,768
positions, each loop over time counted from three of its steps
(``dryrun.LoopCounter``).

Budget: 150 s on one worker (measured 99 s in the whole suite when
xlstm-350m's prefill was traced at 64 positions, 15–21 s of it; that
prefill now takes about 2 s, the prefills of jamba-1.5-large and
deepseek-v3 about 5 s each).
"""
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from test_torch_dryrun import SERVING_RECORDS, check_serving_record


@pytest.mark.parametrize("arch,sname", SERVING_RECORDS)
def test_two_pod_serving_record_is_ok_or_skipped(arch, sname):
    status = check_serving_record(arch, sname, True)
    assert status == ("skipped" if arch == "hubert-xlarge" and sname != "prefill_32k"
                      else "ok")
