"""MPI-style hostfile parsing (parity with reference ``srcs/go/plan/hostfile``).

Copy of ``kungfu_tpu/plan/hostfile.py``.

Format, one host per line::

    192.168.1.10 slots=4
    192.168.1.11 slots=4  # comment

Lines without ``slots=`` default to 1 slot.
"""

from __future__ import annotations

from kungfu_tpu_torch.plan.hostspec import HostList, HostSpec


def parse_hostfile_text(text: str) -> HostList:
    hosts = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        ip = parts[0]
        slots = 1
        for p in parts[1:]:
            if p.startswith("slots="):
                slots = int(p[len("slots="):])
        hosts.append(HostSpec(ip, slots))
    return HostList(hosts)


def parse_hostfile(path: str) -> HostList:
    with open(path) as f:
        return parse_hostfile_text(f.read())
