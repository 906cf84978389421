"""The log-likelihood's share of its roofline: its least time a step
(the model kind's ``loglik_work``, for a ``dfm`` X read, the
log-likelihoods written, 2 k d + 3 k flops a particle at the float32
peak; any implementation of the same math does at least this) over the
device milliseconds a step of the operations launched inside the
program's ``cusmc.likelihood`` spans, whatever computes the phase. A kind
without ``loglik_work``, or a program without the span, reads nothing."""

from portbench import models, spans, work


def read(ctx):
    c = ctx["cell"]
    phase = spans.value(ctx, "device_ms", "cusmc.likelihood")
    if not phase or "kind" not in c:
        return None
    least = getattr(models.kind(c["kind"]), "loglik_work", None)
    if least is None:
        return None
    return 100.0 * work.least_seconds(*least(c)) * 1e3 / phase
