"""autograd_step_share: the gradient steps that took the autograd route
over all gradient steps of the run (the calls of the program's spans
grad.autograd and grad.fast, one a step), in %: 0 where every step took
the fast route (the megakernel's forward and the fused adjoint K6)."""

from portbench import progspans

LAYER, SOURCE, MOVES = "gradient", "program_counter", "grad_paths_per_s"


def read(rec, ctx):
    fast = progspans.span_calls("grad.fast")
    slow = progspans.span_calls("grad.autograd")
    if fast + slow == 0:
        return None
    return 100.0 * slow / (fast + slow)
