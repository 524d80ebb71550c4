"""The host around a run: where the process may run, and what the window cost it.

Read from this process's own files under ``/proc`` and ``/sys`` (read
only) and from ``getrusage``, so that a run's rate can be set beside the
state of the host path that it passed through: the CPUs the process may
run on and their NUMA nodes, the card's node, the transparent huge page
mode, and over the window the process's CPU time, page faults and context
switches, the machine's steal time (time a virtual CPU waited for the
host) and the huge pages the process held. Nothing here changes a
setting.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, Optional

import torch


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _cpulist(cpus) -> str:
    """0,1,2,5 -> '0-2,5'."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
        else:
            if run:
                out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
            run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def _card_node(device: torch.device) -> str:
    if device.type != "cuda":
        return "none"
    props = torch.cuda.get_device_properties(device)
    bus = getattr(props, "pci_bus_id", None)
    dev = getattr(props, "pci_device_id", None)
    dom = getattr(props, "pci_domain_id", 0)
    if bus is None or dev is None:
        return "unknown"
    text = _read(f"/sys/bus/pci/devices/{dom:04x}:{bus:02x}:{dev:02x}.0/numa_node")
    return text.strip() if text else "unknown"


def placement(device: torch.device) -> str:
    """A line: the CPUs this process may run on, the NUMA nodes and their
    CPUs, the card's node, the huge page mode."""
    cpus = os.sched_getaffinity(0)
    nodes = []
    base = "/sys/devices/system/node"
    for name in sorted(os.listdir(base)) if os.path.isdir(base) else []:
        if name.startswith("node") and name[4:].isdigit():
            cl = _read(f"{base}/{name}/cpulist")
            nodes.append(f"{name}:{cl.strip() if cl else '?'}")
    thp = _read("/sys/kernel/mm/transparent_hugepage/enabled")
    model = next((ln.split(":", 1)[1].strip() for ln in (_read("/proc/cpuinfo") or "").splitlines()
                  if ln.startswith("model name")), "unknown")
    return (f"host cpus={_cpulist(cpus)} of {os.cpu_count()} nodes={' '.join(nodes) or 'none'} "
            f"card_node={_card_node(device)} thp={thp.strip() if thp else 'unknown'} "
            f"cpu_model={model!r}")


def _steal_and_idle_s() -> tuple:
    text = _read("/proc/stat")
    if not text:
        return float("nan"), float("nan")
    fields = text.splitlines()[0].split()[1:]
    hz = os.sysconf("SC_CLK_TCK")
    idle = int(fields[3]) + int(fields[4])
    steal = int(fields[7]) if len(fields) > 7 else 0
    return steal / hz, idle / hz


def _anon_huge_kb() -> float:
    for line in (_read("/proc/self/smaps_rollup") or "").splitlines():
        if line.startswith("AnonHugePages:"):
            return float(line.split()[1])
    return float("nan")


def _node_pages() -> str:
    """Pages of this process by NUMA node, from /proc/self/numa_maps."""
    counts: Dict[str, int] = {}
    for line in (_read("/proc/self/numa_maps") or "").splitlines():
        for tok in line.split()[2:]:
            if tok[0] == "N" and "=" in tok and tok[1:tok.index("=")].isdigit():
                node, n = tok.split("=")
                counts[node] = counts.get(node, 0) + int(n)
    return ",".join(f"{k}={v}" for k, v in sorted(counts.items())) or "none"


def snapshot() -> Dict[str, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal, idle = _steal_and_idle_s()
    return {"t": time.perf_counter(), "user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "minflt": ru.ru_minflt, "majflt": ru.ru_majflt, "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw, "steal_s": steal, "idle_s": idle}


def window_line(before: Dict[str, float], after: Dict[str, float], frames: int) -> str:
    """A line: what the window cost the process and the machine."""
    d = {k: after[k] - before[k] for k in before}
    per = max(frames, 1)
    load = (_read("/proc/loadavg") or "? ? ?").split()[:3]
    return (f"host window_s={d['t']:.3f} user_s={d['user_s']:.3f} sys_s={d['sys_s']:.3f} "
            f"minflt={d['minflt']:.0f} minflt_per_frame={d['minflt'] / per:.1f} "
            f"majflt={d['majflt']:.0f} nvcsw={d['nvcsw']:.0f} nivcsw={d['nivcsw']:.0f} "
            f"steal_s={d['steal_s']:.3f} machine_idle_s={d['idle_s']:.3f} "
            f"anon_huge_mb={_anon_huge_kb() / 1024:.1f} pages_by_node={_node_pages()} "
            f"loadavg={' '.join(load)}")
