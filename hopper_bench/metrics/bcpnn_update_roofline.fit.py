"""bcpnn_update_roofline.fit: the trace updates' least time over their
device time, %, in the traced fits.  The least time of each launch is the
larger of its FLOPs at the TF32 peak and its bytes at the HBM peak
(``counts/bcpnn.py::update_traffic``: the state a step must read and
write, each byte once): every unsupervised step updates the hidden
projection and every readout step the readout.  Device time is that of
the kernels named below; where the trace holds another number of them
than the fits launched, nothing is read."""
from counts import bcpnn as counts

KERNELS = ("trace_update_kernel",)


def read(r):
    if r.trace is None or not r.traced:
        return None
    net, batch = r.cell.config["network"], r.cell.traffic["batch"]
    ni = net["input_hc"] * net["input_mc"]
    nj = net["hidden_hc"] * net["hidden_mc"]
    hidden = counts.bound_s(counts.update_traffic(
        batch, ni, nj, net["input_hc"], net["hidden_hc"]))
    readout = counts.bound_s(counts.update_traffic(
        batch, nj, net["n_classes"], net["hidden_hc"], 1))
    least = sum(u["unsup_steps"] * hidden + u["sup_steps"] * readout
                for u in r.traced)
    launches = sum(u["unsup_steps"] + u["sup_steps"] for u in r.traced)
    seconds, n = r.trace.device_time(KERNELS)
    if n != launches or seconds <= 0:
        return None
    return 100.0 * least / seconds
