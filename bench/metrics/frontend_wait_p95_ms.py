"""95th percentile of a request's wait in the ``AsyncFrontend`` before its
batch reaches the executor: lane queueing plus batch assembly, from the
frontend's own stamps (``ServedRequest.phase_s``), over the requests due
in the traced window."""

import numpy as np


def read(t):
    if not t.waits_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(t.waits_s), 95))
