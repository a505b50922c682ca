"""Does ``torch.profiler`` lose device records after a large session?

Counts the device records that 8 sessions of 5 small launches each see
(5 expected), first in a fresh process, then after one CUDA-only session
of 20000 launches, then after one of 100000, then after 100000 launches
outside any session. A session that sees 0 is the "no device activity"
that ``utils/fwd_phases.by_launch`` runs again.

    python3 -m tmae_tpu_torch.utils.profiler_probe

Needs a CUDA device.
"""

from __future__ import annotations

import sys


def main(argv=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print('profiler_probe: no CUDA device', file=sys.stderr)
        return 1
    x = torch.ones(1 << 20, device='cuda')
    y = torch.ones(1 << 10, device='cuda')

    def records(n, t):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                t.mul_(1.0001)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0)

    probe = lambda: [records(5, x) for _ in range(8)]
    print(f'fresh process: {probe()}', flush=True)
    for n in (20000, 100000):
        seen = records(n, y)
        print(f'after a session of {n} launches (it saw {seen}): {probe()}',
              flush=True)
    for _ in range(100000):
        y.mul_(1.0001)
    torch.cuda.synchronize()
    print(f'after 100000 launches outside sessions: {probe()}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
