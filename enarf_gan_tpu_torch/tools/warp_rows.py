"""What bounds A2, one warp copying rows by index in turn
(``csrc/probe_warp_rows.cu``): its loop taken apart at A2's main case,
1,024 rows of 512 bytes from an (8192, 128) float32 table (4 MB, in L2),
one warp for all rows.

* loads alone, by the bytes a lane a load (4, 8, 16: 4, 2, 1 loads a lane
  a row) with 7 groups of 8 rows in flight, and 16 bytes with 1 group: a
  bound by the warp's load instructions gives times in the ratio 4 : 2 : 1
  and none that depends on the depth;
* stores alone;
* the loads with each lane's own stores (A2 without its TMA bulk stores),
  in 1, 2, 4 and 8 warps of one block, each its own loop of 1,024 / W
  rows: a bound of the warp's own scales with W;
* TMA bulk copies fetching the rows, 16 in flight;
* ``row_gather(..., serial_rows=1024)``, A2 itself;
* one row's latency from L2: a chase through 4,096 rows, each naming the
  next.

    python -m enarf_gan_tpu_torch.tools.warp_rows

prints one JSON line: the device µs a call of each (``timing.launch_us``),
the chase's ns a row, and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.tools import gather
from enarf_gan_tpu_torch.tools.timing import cuda_time_ms, launch_us

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = KernelLibrary("probe_warp_rows", "probe_warp_rows",
                       [_I] * 4 + [_P] * 3 + [_I, _I, _P],
                       symbols={"probe_warp_chase": [_P, _I, _P, _P]})
ROWS, TABLE_ROWS = 1024, 8192
# label: (kind, bytes a lane a load, groups in the ring, warps a block)
PARTS = {"loads 4 B a lane": (0, 4, 8, 1), "loads 8 B a lane": (0, 8, 8, 1),
         "loads 16 B a lane": (0, 16, 8, 1),
         "loads 16 B a lane, 1 group in flight": (0, 16, 2, 1),
         "stores": (2, 16, 0, 1),
         "loads and lane stores, 1 warp": (1, 16, 4, 1),
         "loads and lane stores, 2 warps": (1, 16, 4, 2),
         "loads and lane stores, 4 warps": (1, 16, 4, 4),
         "loads and lane stores, 8 warps": (1, 16, 4, 8),
         "TMA bulk loads and lane stores": (3, 16, 0, 1)}


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the study runs on an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    tab = torch.randn((TABLE_ROWS, 128), generator=g, device="cuda")
    idx = torch.randint(0, TABLE_ROWS, (ROWS,), generator=g, device="cuda",
                        dtype=torch.int32)
    ref = tab[idx.long()]
    stream = torch.cuda.current_stream().cuda_stream
    fn = KERNEL.load()
    out = {"device_us": {}}
    for label, (kind, B, S, W) in PARTS.items():
        got = torch.zeros_like(ref)

        def call():
            err = fn(kind, B, S, W, tab.data_ptr(), idx.data_ptr(),
                     got.data_ptr(), ROWS, ROWS // W, stream)
            if err:
                raise RuntimeError(f"{label}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if kind in (1, 3):
            assert torch.equal(got, ref), f"{label} differs from tab[idx]"
        out["device_us"][label] = launch_us(call)[1]
    a2 = gather.row_gather(tab, idx, ROWS)
    torch.cuda.synchronize()
    assert torch.equal(a2, ref)
    out["device_us"]["A2 row_gather, 1,024 rows a warp"] = launch_us(
        lambda: gather.row_gather(tab, idx, ROWS))[1]
    # the chase: a cycle through every row, in random order
    perm = torch.randperm(TABLE_ROWS, generator=torch.Generator().manual_seed(1))
    nxt = torch.empty(TABLE_ROWS, dtype=torch.int64)
    nxt[perm] = perm.roll(-1)
    ctab = torch.zeros((TABLE_ROWS, 128), dtype=torch.int32)
    ctab[:, 0] = nxt.int()
    ctab = ctab.cuda()
    last = torch.zeros(1, dtype=torch.int32, device="cuda")
    chase = KERNEL.load("probe_warp_chase")
    hops = 4096
    ms = cuda_time_ms(lambda: chase(ctab.data_ptr(), hops, last.data_ptr(),
                                    stream), 10)
    out["chase_ns_a_row"] = ms * 1e6 / hops
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
