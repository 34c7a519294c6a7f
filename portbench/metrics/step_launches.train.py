"""Kernel launch calls a train step makes: the CUDA runtime and ``cu`` API
calls that launch a kernel or a graph (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``, ``cuLaunchKernelEx``, ``cudaGraphLaunch``: a graph
counts once) that start inside one of the port's ``S|step`` ranges of the
traced stretch, on any thread, over the number of those ranges
(``program_spans.step_launches``)."""

from portbench.program_spans import step_launches


def read(rec):
    return step_launches(rec.trace)
