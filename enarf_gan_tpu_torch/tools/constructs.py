"""Family D of the probes: one-construct kernels and launch cost
(``csrc/probe_ops.cu``).

``construct(name, *inputs)`` runs one construct of the TPU compile bisects
(``CONSTRUCTS``: name -> its tools/ call site) as its own kernel;
``construct_plain`` is the ``jnp`` body of the probe written in PyTorch.
``roster(name, inputs, outputs)`` launches a trivial kernel with one of
``tools/probe_call_structure.py``'s argument rosters, and ``launch_cost``
measures what a launch through the port's ctypes wrappers costs: host
microseconds a call (``time.perf_counter`` over 1,000 launches, one
synchronise at the end) and device microseconds a launch (CUDA events
around 1,000 launches queued behind ``probe_spin``, so that the card runs
them back to back).

    python -m enarf_gan_tpu_torch.tools.constructs [--device cpu]
"""
from __future__ import annotations

import ctypes
import time

import torch

from enarf_gan_tpu_torch.cuda_build import KernelLibrary
from enarf_gan_tpu_torch.tools.timing import Case, run_cli

SOURCE = "enarf_gan_tpu_torch/csrc/probe_ops.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# name: (Op index in probe_ops.cu, replaces)
CONSTRUCTS = {
    "load_c": (0, "tools/bisect_hat_kernel.py:64"),
    "hat_bcast": (1, "tools/bisect_hat_kernel.py:70"),
    "cat_sub": (2, "tools/bisect_hat_kernel.py:78"),
    "lane_slice": (3, "tools/bisect_hat_kernel.py:85"),
    "mask_hat": (4, "tools/bisect_hat_kernel.py:120"),
    "block6d": (5, "tools/bisect_kernel_ops.py:46"),
    "concat_mid": (6, "tools/bisect_kernel_ops.py:59"),
    "reshape_lead": (7, "tools/bisect_kernel_ops.py:68"),
    "iota_sepw": (8, "tools/bisect_kernel_ops.py:76"),
    "sigmoid_prod": (9, "tools/bisect_kernel_ops.py:105"),
    "multi_out": (10, "tools/bisect_kernel_ops.py:115"),
    "grid_6d": (11, "tools/bisect_kernel_ops.py:132"),
    "warm": (12, "tools/probe_kernel_variants.py:46"),
    "reshape_fm": (13, "tools/probe_mosaic_caps.py:58"),
    "reshape_tm": (14, "tools/probe_mosaic_caps.py:62"),
    "ewr": (15, "tools/probe_mosaic_caps.py:114"),
    "expand": (16, "tools/probe_mosaic_coord_ops.py:45"),
    "bcast": (17, "tools/probe_mosaic_coord_ops.py:52"),
}
# name: (inputs, outputs) of tools/probe_call_structure.py's rosters
ROSTERS = {"6d_in_1out": (1, 1), "6d_5d_1out": (2, 1), "6d_2out": (1, 2),
           "7in_1out": (7, 1), "7in_2out": (7, 2)}
KERNEL = KernelLibrary(
    "probe_ops", "probe_construct",
    [_I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P],
    keys=tuple(CONSTRUCTS) + tuple(ROSTERS),
    symbols={**{f"probe_roster_{i}_{o}": [_P] * (i + o + 1)
                for i, o in ROSTERS.values()},
             "probe_spin": [ctypes.c_longlong, _P]})
ROSTER_ELEMS = 32              # floats the roster kernels touch an argument


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _hat(t, x):
    return torch.clamp(1.0 - (t - x).abs(), min=0.0)


def construct_plain(name, x, y=None):
    """The probe's jnp body in PyTorch (float32 out)."""
    dev = x.device
    if name in ("load_c", "warm"):
        return x * 2.0
    if name == "hat_bcast":                    # x (U, M, 1)
        return _hat(torch.arange(128, device=dev).float(), x).sum(-1,
                                                                 keepdim=True)
    if name == "cat_sub":
        M = x.shape[1]
        x2 = torch.cat([x, x], 1)
        return x2[:, :M] + x2[:, M:]
    if name == "lane_slice":                   # x (U, M, 1), y win (U, M, 128)
        d = y.float()
        return sum(d[:, :, 32 * q:32 * (q + 1)] * (x + q) for q in range(4))
    if name == "mask_hat":
        t = torch.arange(64, device=dev)
        return (_hat((t // 8).float(), x) * _hat((t % 8).float(), x)) \
            .sum(-1, keepdim=True)
    if name == "block6d":                      # (1, 3, Mp, TB, 16, 128) bf16
        return x[0].float().sum(dim=(0, 1, 3))
    if name == "concat_mid":
        return torch.cat([x, x], 1)
    if name == "reshape_lead":
        return x.reshape(-1, x.shape[-1])
    if name == "iota_sepw":                    # x (TB, M)
        M = x.shape[1]
        sig = torch.arange(16, device=dev)
        half = (torch.arange(2 * M, device=dev) // M).float()[:, None]
        c = torch.cat([x, x], 1)[..., None]
        return torch.where((sig // 2).float() == c, 1.0, 0.0) \
            * ((sig % 2).float() == half)
    if name == "sigmoid_prod":
        cw = torch.ones_like(x)
        for _ in range(3):
            cw = cw * torch.sigmoid(x)
        return cw
    if name == "multi_out":
        return x * 2.0, x + 1.0
    if name == "grid_6d":
        return x[0, 0, 0].float().sum(1)
    if name == "reshape_fm":                   # (TB, 2048) bf16
        return x.reshape(x.shape[0], 32, 64).float().sum(-1)
    if name == "reshape_tm":
        return x.reshape(x.shape[0], 64, 32).float().sum(-2)
    if name == "ewr":                          # (TB,16,64), (TB,32,64) bf16
        return (x.float()[:, :, None, :] * y.float()[:, None, :, :]).sum(-1)
    if name == "expand":                       # x (M, TB)
        M, TB = x.shape
        return x.t()[:, :, None] + torch.zeros((TB, M, 128), device=dev)
    if name == "bcast":
        xt = x.t()
        x2 = torch.cat([xt, xt], 1)
        lam = torch.arange(128, device=dev)
        return _hat(((lam % 16) // 2).float(), x2[..., None])
    raise ValueError(f"unknown construct {name!r}")


def _out_shape_dims(name, x, y):
    """(output shape, d0, d1) of a construct's kernel."""
    if name in ("load_c", "warm", "hat_bcast", "mask_hat", "sigmoid_prod",
                "multi_out"):
        return tuple(x.shape), 0, 0
    if name == "cat_sub":
        return tuple(x.shape), x.shape[1], 0
    if name == "lane_slice":
        return (x.shape[0], x.shape[1], 32), x.shape[1], 0
    if name == "block6d":
        return (x.shape[3], 128), x.shape[3], x.shape[2]
    if name == "concat_mid":
        return (x.shape[0], 2 * x.shape[1]), x.shape[1], 0
    if name == "reshape_lead":
        return (x.numel() // x.shape[-1], x.shape[-1]), 0, 0
    if name == "iota_sepw":
        return (x.shape[0], 2 * x.shape[1], 16), x.shape[1], 0
    if name == "grid_6d":
        return (x.shape[3], 128), 0, 0
    if name in ("reshape_fm", "reshape_tm"):
        return (x.shape[0], 32), 0, 0
    if name == "ewr":
        return (x.shape[0], x.shape[1], 32), 0, 0
    if name == "expand":
        return (x.shape[1], x.shape[0], 128), x.shape[1], x.shape[0]
    if name == "bcast":
        return (x.shape[1], 2 * x.shape[0], 128), x.shape[1], x.shape[0]
    raise ValueError(f"unknown construct {name!r}")


def _coords(x, y):
    return x.dim() == 3 and x.shape[2] == 1


def _rows6(x, y):
    return x.dim() == 6 and x.shape[:2] == (1, 3) and x.shape[4:] == (16, 128)


def _wide(x, y):
    return x.dim() == 2 and x.shape[1] == 2048


def _matrix(x, y):
    return x.dim() == 2


_SHAPE_OK = {
    "load_c": _coords, "hat_bcast": _coords, "cat_sub": _coords,
    "mask_hat": _coords,
    "lane_slice": lambda x, y: _coords(x, y) and y.dtype == torch.bfloat16
    and tuple(y.shape) == (x.shape[0], x.shape[1], 128),
    "ewr": lambda x, y: x.dim() == 3 and x.shape[1:] == (16, 64)
    and y.dtype == torch.bfloat16 and tuple(y.shape) == (x.shape[0], 32, 64),
    "block6d": _rows6, "grid_6d": _rows6,
    "reshape_fm": _wide, "reshape_tm": _wide,
    "reshape_lead": lambda x, y: x.dim() >= 2,
    "concat_mid": _matrix, "iota_sepw": _matrix, "sigmoid_prod": _matrix,
    "multi_out": _matrix, "warm": _matrix, "expand": _matrix,
    "bcast": _matrix}
_BF16_INPUTS = ("block6d", "grid_6d", "reshape_fm", "reshape_tm", "ewr")
_TWO_INPUTS = ("lane_slice", "ewr")


def _check_construct(name, x, y):
    if name not in CONSTRUCTS:
        raise ValueError(f"construct must be one of {tuple(CONSTRUCTS)}, got "
                         f"{name!r}")
    want = torch.bfloat16 if name in _BF16_INPUTS else torch.float32
    if x.dtype != want:
        raise ValueError(f"{name} takes {want} input, got {x.dtype}")
    if (name in _TWO_INPUTS) != (y is not None):
        raise ValueError(f"{name} takes "
                         f"{'two inputs' if name in _TWO_INPUTS else 'one'}")
    if not _SHAPE_OK[name](x, y):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}"
                         f"{'' if y is None else ', ' + str(tuple(y.shape))} "
                         f"are not the construct's")


def construct(name, x, y=None):
    """Run construct ``name`` on x (and y); float32 output(s)."""
    _check_construct(name, x, y)
    if not x.is_cuda:
        return construct_plain(name, x, y)
    for t in (x, y):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("the kernel takes contiguous tensors on one device")
    shape, d0, d1 = _out_shape_dims(name, x, y)
    out0 = torch.empty(shape, dtype=torch.float32, device=x.device)
    out1 = torch.empty_like(out0) if name == "multi_out" else None
    err = KERNEL.load()(CONSTRUCTS[name][0], x.data_ptr(),
                        None if y is None else y.data_ptr(), out0.data_ptr(),
                        None if out1 is None else out1.data_ptr(),
                        out0.numel(), d0, d1, 0, _stream(x))
    if err != 0:
        raise RuntimeError(f"probe_construct {name} launch failed: CUDA "
                           f"error {err}")
    KERNEL.count(name)
    return out0 if out1 is None else (out0, out1)


# ----------------------------------------------------------- launch cost

def roster_plain(name, inputs):
    s = sum(t[:ROSTER_ELEMS] for t in inputs)
    return (s, 2.0 * inputs[0][:ROSTER_ELEMS]) if ROSTERS[name][1] == 2 \
        else s


def roster(name, inputs, outputs):
    """Launch the trivial kernel of roster ``name`` (float32 tensors of at
    least 32 elements); out0[:32] = sum of the inputs' first 32, out1[:32]
    = 2 in0[:32]. Returns the outputs' first 32 elements."""
    n_in, n_out = ROSTERS[name]
    if len(inputs) != n_in or len(outputs) != n_out:
        raise ValueError(f"roster {name} takes {n_in} inputs and {n_out} "
                         f"outputs")
    for t in (*inputs, *outputs):
        if t.dtype != torch.float32 or t.numel() < ROSTER_ELEMS \
                or not t.is_contiguous() or t.device != inputs[0].device:
            raise ValueError("roster arguments are contiguous float32 tensors "
                             "of at least 32 elements on one device")
    if not inputs[0].is_cuda:
        out = roster_plain(name, [t.reshape(-1) for t in inputs])
        return out
    err = KERNEL.load(f"probe_roster_{n_in}_{n_out}")(
        *(t.data_ptr() for t in (*inputs, *outputs)), _stream(inputs[0]))
    if err != 0:
        raise RuntimeError(f"probe_roster {name} launch failed: CUDA error "
                           f"{err}")
    KERNEL.count(name)
    flat = [t.reshape(-1)[:ROSTER_ELEMS] for t in outputs]
    return flat[0] if n_out == 1 else tuple(flat)


def roster_args(name, device, g):
    """The roster's tensors, shaped as the hat kernel's blocks were: a 6-D
    window block, a 5-D mask block, 5-D coordinates, 4-D validity; 4-D
    outputs (float32, small)."""
    n_in, n_out = ROSTERS[name]
    shapes = [(1, 3, 4, 2, 16, 128), (1, 3, 4, 2, 64)] + [(1, 3, 4, 2, 16)] * 4 \
        + [(1, 4, 2, 16)]
    if n_in == 1:
        shapes = shapes[:1]
    elif n_in == 2:
        shapes = shapes[:2]
    ins = [torch.randn(s, generator=g, device=device) for s in shapes]
    outs = [torch.empty((1, 2, 16, 32), device=device) for _ in range(n_out)]
    return ins, outs


def launch_cost(name, device, n=1000, spin_ms=50.0):
    """(host µs a call through ``roster``, device µs a launch): the host
    clock over n calls with one synchronise at the end; CUDA events around
    n launches queued behind a spin kernel of ``spin_ms``, which hold the
    card until they are all enqueued."""
    g = torch.Generator(device=device).manual_seed(3)
    ins, outs = roster_args(name, device, g)
    roster(name, ins, outs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        roster(name, ins, outs)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / n * 1e6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    err = KERNEL.load("probe_spin")(int(spin_ms * 1e6), _stream(ins[0]))
    if err != 0:
        raise RuntimeError(f"probe_spin launch failed: CUDA error {err}")
    start.record()
    for _ in range(n):
        roster(name, ins, outs)
    end.record()
    torch.cuda.synchronize()
    return host_us, start.elapsed_time(end) / n * 1e3


# ----------------------------------------------------------------- cases

def construct_inputs(name, device, g):
    """The probe's inputs (its own shapes and distributions)."""
    def f32(*s):
        return torch.randn(s, generator=g, device=device)

    def bf16(*s):
        return f32(*s).to(torch.bfloat16)

    U, M, TB, Mp = 256, 16, 128, 4
    coord = (torch.rand((U, M, 1), generator=g, device=device) * 6,)
    return {
        "load_c": coord, "hat_bcast": coord, "cat_sub": coord,
        "mask_hat": coord,
        "lane_slice": (coord[0], bf16(U, 16, 128)),
        "block6d": (bf16(1, 3, Mp, TB, 16, 128),),
        "concat_mid": (f32(TB, M),),
        "reshape_lead": (f32(TB, M, 128),),
        # whole texel numbers in [0, 8), so that the compare hits
        "iota_sepw": (torch.randint(0, 8, (TB, M), generator=g,
                                    device=device).float(),),
        "sigmoid_prod": (f32(TB, M),), "multi_out": (f32(TB, M),),
        "grid_6d": (bf16(1, 3, Mp, 2 * TB, 16, 128),),
        "warm": (f32(128, 128),),
        "reshape_fm": (bf16(TB, 2048),), "reshape_tm": (bf16(TB, 2048),),
        "ewr": (bf16(TB, 16, 64), bf16(TB, 32, 64)),
        "expand": (torch.rand((M, TB), generator=g, device=device) * 7,),
        "bcast": (torch.rand((M, TB), generator=g, device=device) * 7,),
    }[name]


_REDUCE_TERMS = {"hat_bcast": 128, "mask_hat": 64, "block6d": 192,
                 "grid_6d": 16, "reshape_fm": 64, "reshape_tm": 64,
                 "ewr": 64, "lane_slice": 4}


def cases(device, size="main"):
    """Every construct at its probe's shape, and every roster (the same at
    every size: the probes' shapes are small)."""
    g = torch.Generator(device=device).manual_seed(2)
    for name, (_, replaces) in CONSTRUCTS.items():
        ins = construct_inputs(name, device, g)
        outs = construct_plain(name, *ins)
        out_elems = sum(o.numel() for o in
                        (outs if isinstance(outs, tuple) else (outs,)))
        if name == "grid_6d":                  # reads plane 0, slot 0 only
            in_bytes = ins[0][0, 0, 0].numel() * 2.0
        else:
            in_bytes = float(sum(t.numel() * t.element_size() for t in ins))
        terms = _REDUCE_TERMS.get(name, 1)
        yield Case(
            f"D {name}", replaces, SOURCE,
            kernel=lambda n=name, a=ins: construct(n, *a),
            plain=lambda n=name, a=ins: construct_plain(n, *a),
            counter=(KERNEL, name), nbytes=in_bytes + out_elems * 4.0,
            flops=2.0 * out_elems * terms,
            # float32 sums in another order; expf against torch's sigmoid
            rtol=1e-5, atol=1e-5,
            info={"inputs": [list(t.shape) for t in ins]})
    for name in ROSTERS:
        ins, outs = roster_args(name, device, g)
        flat = [t.reshape(-1) for t in ins]
        yield Case(
            f"D launch roster {name}", "tools/probe_call_structure.py:55",
            SOURCE, kernel=lambda n=name, a=ins, o=outs: roster(n, a, o),
            plain=lambda n=name, a=flat: roster_plain(n, a),
            counter=(KERNEL, name),
            nbytes=4.0 * ROSTER_ELEMS * sum(ROSTERS[name]), rtol=1e-6,
            atol=1e-6, info={"inputs": ROSTERS[name][0],
                             "outputs": ROSTERS[name][1]})



def main(argv=None):
    return run_cli(cases, argv, __doc__)


if __name__ == "__main__":
    main()
