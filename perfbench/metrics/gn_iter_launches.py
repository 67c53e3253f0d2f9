"""Device operations (kernels, copies, fills) launched inside the
program's ``codd.motion.gn_iter`` spans per such span: the launches of
one GN iteration, which CUDA graphs and folded ops would cut
(``perfbench/harness/spans.py``)."""

from perfbench.harness import spans


def read(trace):
    table = spans.of(trace)
    if table is None or table.launches("motion.gn_iter") is None:
        return None
    return table.launches("motion.gn_iter") / table.count["motion.gn_iter"]
