"""K2a's and K2b's table read, measured on one GPU, and their instruction
counts.

    python -m qaray_tpu_torch.tools.k2_layout

K2a and K2b (csrc/analytic.cu) stage the primitive table in shared memory
once a block and read each row as three float4 in the winner-only sweep.
The variants, built with nvcc into build/k2_layout/ from a copy of the
source with the variant kernels of APPENDIX added at its end:
- "kept": the source's own kernels (qr_closest, qr_closest_full);
- "param table": the table passed by value in the kernel's parameter space
  (a __grid_constant__ struct of up to 64 rows), read by constant loads,
  with no staging and no barrier; the table must then be on the host at
  every call, which the wrapper does not have without a copy from the
  device;
- "scalar rows": the kept kernels with the parent's table read, 13 scalar
  loads from shared memory a test (closest_scalar, the parent's sweep);
- "global rows" and "ldg rows": no staging and no barrier, each row read
  from device memory as three float4, by plain loads or through the
  read-only path (__ldg);
- K2a alone (K2A_SPLIT): the parent's K2a (__restrict__ pointer
  arguments, no launch bounds, an int ray index, its scalar sweep) and it
  with one of the kept kernel's departures each: float4 rows, the 64-bit
  ray index, __launch_bounds__, ClosestParams.
Each runs at kernel_times.K2_SIZES on chip_smoke.py phase 2a's random rays
and on the rays of bounces 0 and 1 of a wavefront batch of softdof of that
size (kernel_times.batch_rays), K2a, and K2b with and without the uv.
Every variant's outputs are held equal to the kept kernel's, bit for bit.
Times are torch.profiler's device time of the kernel, the mean over 20
launches after one that is not counted, each variant timed twice in turns
(forward, then in reverse order).

Every kernel's instructions up to its first unpredicated EXIT and its
shared-memory loads (and how many of them are 64- or 128-bit) are printed
from its SASS. The SASS probes of APPENDIX count, with cuobjdump -sass,
the instructions of one primitive test of each kind (a probe of two tests
less a probe of one) and of the winner's attribute block of each kind with
and without the uv, on the path that takes no IEEE slow path (up to the
function's first unpredicated EXIT). From them, for each ray set, the
issue-rate floor of the kept design (each warp pays every test, and the
attribute block of each kind some lane of it won) and of the parent's
(each warp also pays a primitive's attribute block wherever some lane
takes it as a new winner), at 4 warp instructions a clock on each SM at
the card's maximum SM clock: the instructions of the tests and attribute
blocks alone, so a lower bound.

Prints the card's name and power limit and, last, one JSON line.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from qaray_tpu_torch.tools.kernel_times import (
    K2_SIZES,
    batch_rays,
    device_ms,
    shadow_rays,
)

APPENDIX = r'''
// ---- Variants of K2a and K2b and SASS probes (tools/k2_layout.py) ----
#include <string.h>

namespace {

constexpr int kParamRows = 64;  // 3,328 bytes beside ClosestParams' 112

struct ParamTable {
  float4 rows[3 * kParamRows];
  int kinds[kParamRows];
};

template <bool kFull, bool kWantUv>
__global__ void __launch_bounds__(kThreads)
    param_kernel(const ClosestParams P, const __grid_constant__ ParamTable T) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const V3 p = load3(P.p + 3 * (size_t)i), d = load3(P.d + 3 * (size_t)i);
  int k;
  const float t = closest_rows(T.rows, T.kinds, P.num_prims, p, d, k);
  store_closest<kFull, kWantUv>(P, T.rows, T.kinds, i, p, d, t, k);
}

// The parent's sweep: closest_rows with the row read as 12 scalar loads.
__device__ __forceinline__ float closest_scalar(const float* prims,
                                                const int* kinds,
                                                int num_prims, V3 p, V3 d,
                                                int& idx) {
  float t_best = QR_BIGFLOAT;
  idx = 0;
  for (int k = 0; k < num_prims; ++k) {
    V3 po, dobj;
    obj_ray(prims + k * QR_PRIM_COLS, p, d, po, dobj);
    const float th = prim_t(kinds[k], po, dobj);
    if (th < t_best) {
      t_best = th;
      idx = k;
    }
  }
  return t_best;
}

template <bool kFull, bool kWantUv>
__global__ void __launch_bounds__(kThreads)
    scalar_kernel(const ClosestParams P) {
  QR_SHARED_FLOATS(tab);
  int* s_kind = reinterpret_cast<int*>(tab + P.num_prims * QR_PRIM_COLS);
  stage_prims(P.prim, P.kinds, P.num_prims, tab, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const V3 p = load3(P.p + 3 * (size_t)i), d = load3(P.d + 3 * (size_t)i);
  int k;
  const float t = closest_scalar(tab, s_kind, P.num_prims, p, d, k);
  store_closest<kFull, kWantUv>(P, reinterpret_cast<const float4*>(tab),
                                s_kind, i, p, d, t, k);
}

// The table read straight from device memory, no staging and no barrier:
// rows as three float4 through L1 (plain loads) or the read-only path.
template <bool kFull, bool kWantUv>
__global__ void __launch_bounds__(kThreads)
    global_kernel(const ClosestParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const float4* rows = reinterpret_cast<const float4*>(P.prim);
  const V3 p = load3(P.p + 3 * (size_t)i), d = load3(P.d + 3 * (size_t)i);
  int k;
  const float t = closest_rows(rows, P.kinds, P.num_prims, p, d, k);
  store_closest<kFull, kWantUv>(P, rows, P.kinds, i, p, d, t, k);
}

__device__ __forceinline__ float closest_rows_ldg(
    const float4* __restrict__ rows, const int* __restrict__ kinds,
    int num_prims, V3 p, V3 d, int& idx) {
  float t_best = QR_BIGFLOAT;
  idx = 0;
  for (int k = 0; k < num_prims; ++k) {
    const float4 a = __ldg(rows + 3 * k), b = __ldg(rows + 3 * k + 1),
                 c = __ldg(rows + 3 * k + 2);
    const float pr[QR_PRIM_COLS] = {a.x, a.y, a.z, a.w, b.x, b.y,
                                    b.z, b.w, c.x, c.y, c.z, c.w};
    V3 po, dobj;
    obj_ray(pr, p, d, po, dobj);
    const float th = prim_t(__ldg(kinds + k), po, dobj);
    if (th < t_best) {
      t_best = th;
      idx = k;
    }
  }
  return t_best;
}

template <bool kFull, bool kWantUv>
__global__ void __launch_bounds__(kThreads) ldg_kernel(const ClosestParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const float4* rows = reinterpret_cast<const float4*>(P.prim);
  const V3 p = load3(P.p + 3 * (size_t)i), d = load3(P.d + 3 * (size_t)i);
  int k;
  const float t = closest_rows_ldg(rows, P.kinds, P.num_prims, p, d, k);
  store_closest<kFull, kWantUv>(P, rows, P.kinds, i, p, d, t, k);
}

// K2a's departures from the parent's kernel, one at a time, to split the
// kept kernel's time against the parent's. The parent's K2a takes
// __restrict__ pointer arguments, no launch
// bounds, an int ray index, and its sweep (closest_scalar) over the table
// declared 4-byte aligned, as the parent declared it: k2a_parent. kRows
// reads the rows as three float4 (closest_rows: k2a_rows), kWide indexes
// rays in 64 bits (k2a_wide); k2a_bounds adds __launch_bounds__(kThreads),
// k2a_struct takes ClosestParams.
template <bool kRows, bool kWide>
__device__ __forceinline__ void k2a_split(const float* p, const float* d,
                                          int n, const float* prim,
                                          const int* kinds, int num_prims,
                                          float* t_out, int* idx_out) {
  extern __shared__ float smem4[];
  int* s_kind = reinterpret_cast<int*>(smem4 + num_prims * QR_PRIM_COLS);
  stage_prims(prim, kinds, num_prims, smem4, s_kind);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 pi, di;
  if constexpr (kWide) {
    pi = load3(p + 3 * (size_t)i);
    di = load3(d + 3 * (size_t)i);
  } else {
    pi = load3(p + 3 * i);
    di = load3(d + 3 * i);
  }
  int idx;
  float t;
  if constexpr (kRows)
    t = closest_rows(reinterpret_cast<const float4*>(smem4), s_kind,
                     num_prims, pi, di, idx);
  else
    t = closest_scalar(smem4, s_kind, num_prims, pi, di, idx);
  t_out[i] = t;
  idx_out[i] = idx;
}

#define QR_K2A_ARGS                                                     \
  const float* __restrict__ p, const float* __restrict__ d, int n,      \
      const float* __restrict__ prim, const int* __restrict__ kinds,    \
      int num_prims, float* __restrict__ t_out, int* __restrict__ idx_out

#define QR_K2A_KERNEL(name, bounds, rows, wide)                          \
  __global__ void bounds name(QR_K2A_ARGS) {                             \
    k2a_split<rows, wide>(p, d, n, prim, kinds, num_prims, t_out, idx_out); \
  }
QR_K2A_KERNEL(k2a_parent, , false, false)
QR_K2A_KERNEL(k2a_rows, , true, false)
QR_K2A_KERNEL(k2a_wide, , false, true)
QR_K2A_KERNEL(k2a_bounds, __launch_bounds__(kThreads), false, false)

__global__ void k2a_struct(const ClosestParams P) {
  k2a_split<false, false>(P.p, P.d, P.n, P.prim, P.kinds, P.num_prims, P.t,
                          P.idx);
}

// Variants 5-9 (K2a only): the parent's K2a, then it with float4 rows,
// the 64-bit index, the launch bounds, ClosestParams.
int k2a_split_launch(int variant, const ClosestParams& P,
                     cudaStream_t s) {
  const int blocks = (P.n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)P.num_prims * (QR_PRIM_COLS + 1) * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
#define QR_K2A_CALL(kernel)                                             \
  kernel<<<blocks, kThreads, smem, s>>>(P.p, P.d, P.n, P.prim,     \
                                             P.kinds, P.num_prims, P.t, \
                                             P.idx)
  switch (variant) {
    case 5: QR_K2A_CALL(k2a_parent); break;
    case 6: QR_K2A_CALL(k2a_rows); break;
    case 7: QR_K2A_CALL(k2a_wide); break;
    case 8: QR_K2A_CALL(k2a_bounds); break;
    case 9: k2a_struct<<<blocks, kThreads, smem, s>>>(P); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef QR_K2A_CALL
  return (int)cudaGetLastError();
}

}  // namespace

struct ProbeArgs {
  const float* p;
  const float* d;
  const float* rows;  // [2, 12], 16-byte aligned
  const float* t;     // [n, 2]
  float* out;         // [n, 6]
};

// kTests primitive tests of kind kKind on rows 0.., summed.
template <int kKind, int kTests>
__device__ __forceinline__ void probe_tests(const ProbeArgs& A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const V3 p = load3(A.p + 3 * i), d = load3(A.d + 3 * i);
  const float4* rows = reinterpret_cast<const float4*>(A.rows);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kTests; ++j) {
    float pr[QR_PRIM_COLS];
    table_row(rows, j, pr);
    V3 po, dobj;
    obj_ray(pr, p, d, po, dobj);
    acc += prim_t(kKind, po, dobj);
  }
  A.out[i] = acc;
}

// kBlocks attribute blocks of kind kKind on rows 0.., summed.
template <int kKind, bool kWantUv, int kBlocks>
__device__ __forceinline__ void probe_attrs(const ProbeArgs& A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const V3 p = load3(A.p + 3 * i), d = load3(A.d + 3 * i);
  const float4* rows = reinterpret_cast<const float4*>(A.rows);
  const int kinds[2] = {kKind, kKind};
  float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
    const Hit h = winner_hit<kWantUv>(rows, kinds, j, p, d, A.t[2 * i + j]);
    s[0] += h.n.x;
    s[1] += h.n.y;
    s[2] += h.n.z;
    s[3] += h.u;
    s[4] += h.v;
    s[5] += h.front ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) A.out[6 * i + j] = s[j];
}

#define QR_PROBE_TESTS(name, kind, n) \
  extern "C" __global__ void name(const ProbeArgs A) { \
    probe_tests<kind, n>(A); \
  }
#define QR_PROBE_ATTRS(name, kind, uv, n) \
  extern "C" __global__ void name(const ProbeArgs A) { \
    probe_attrs<kind, uv, n>(A); \
  }
QR_PROBE_TESTS(probe_sphere_tests_1, 0, 1)
QR_PROBE_TESTS(probe_sphere_tests_2, 0, 2)
QR_PROBE_TESTS(probe_plane_tests_1, 1, 1)
QR_PROBE_TESTS(probe_plane_tests_2, 1, 2)
QR_PROBE_ATTRS(probe_sphere_uv_1, 0, true, 1)
QR_PROBE_ATTRS(probe_sphere_uv_2, 0, true, 2)
QR_PROBE_ATTRS(probe_sphere_nouv_1, 0, false, 1)
QR_PROBE_ATTRS(probe_sphere_nouv_2, 0, false, 2)
QR_PROBE_ATTRS(probe_plane_uv_1, 1, true, 1)
QR_PROBE_ATTRS(probe_plane_uv_2, 1, true, 2)
QR_PROBE_ATTRS(probe_plane_nouv_1, 1, false, 1)
QR_PROBE_ATTRS(probe_plane_nouv_2, 1, false, 2)

// variant 1: param_kernel (host_table and host_kinds on the host), 2:
// scalar_kernel, 3: global_kernel, 4: ldg_kernel, 5-9 (K2a only):
// k2a_split_launch; full 0 is K2a.
extern "C" int qr_k2_variant(int variant, int full, int want_uv,
                             const float* host_table, const int* host_kinds,
                             const float* p, const float* d, int n,
                             const float* prim, const int* kinds,
                             const int* prim_mtl, int num_prims, float* t_out,
                             int* idx_out, float* n_out, float* uvw_out,
                             uint8_t* front_out, int* mtl_out, float* hp_out,
                             uint8_t* has_texture_out, void* stream) {
  const ClosestParams P{p,        d,         n,       prim,   kinds,
                        prim_mtl, num_prims, t_out,   idx_out, n_out,
                        uvw_out,  front_out, mtl_out, hp_out, has_texture_out};
  if (variant == 2) {
    if (!full) return launch_closest(scalar_kernel<false, false>, P, stream);
    return want_uv ? launch_closest(scalar_kernel<true, true>, P, stream)
                   : launch_closest(scalar_kernel<true, false>, P, stream);
  }
  if (variant == 3) {
    if (!full) return launch_closest(global_kernel<false, false>, P, stream);
    return want_uv ? launch_closest(global_kernel<true, true>, P, stream)
                   : launch_closest(global_kernel<true, false>, P, stream);
  }
  if (variant >= 5) {
    if (full) return (int)cudaErrorInvalidValue;
    return k2a_split_launch(variant, P, (cudaStream_t)stream);
  }
  if (variant == 4) {
    if (!full) return launch_closest(ldg_kernel<false, false>, P, stream);
    return want_uv ? launch_closest(ldg_kernel<true, true>, P, stream)
                   : launch_closest(ldg_kernel<true, false>, P, stream);
  }
  if (num_prims > kParamRows) return (int)cudaErrorInvalidValue;
  ParamTable T;
  memcpy(T.rows, host_table, sizeof(float) * QR_PRIM_COLS * num_prims);
  memcpy(T.kinds, host_kinds, sizeof(int) * num_prims);
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (!full)
    param_kernel<false, false><<<blocks, kThreads, 0, s>>>(P, T);
  else if (want_uv)
    param_kernel<true, true><<<blocks, kThreads, 0, s>>>(P, T);
  else
    param_kernel<true, false><<<blocks, kThreads, 0, s>>>(P, T);
  return (int)cudaGetLastError();
}
'''

VARIANTS = {"kept": 0, "param table": 1, "scalar rows": 2,
            "global rows": 3, "ldg rows": 4}
# K2a alone: the parent's kernel and it with one of the kept kernel's
# departures (k2a_split_launch).
K2A_SPLIT = {"parent K2a": 5, "parent + float4 rows": 6,
             "parent + 64-bit index": 7, "parent + launch bounds": 8,
             "parent + ClosestParams": 9}
PROBES = ("sphere_tests", "plane_tests", "sphere_uv", "sphere_nouv",
          "plane_uv", "plane_nouv")
# Operations a probe adds per block besides the block itself: a test's
# one addition, an attribute block's six (and front's select).
PROBE_EXTRA = {"tests": 1, "uv": 7, "nouv": 7}


def build():
    """The variant library (csrc/analytic.cu + APPENDIX) and nvcc's
    report."""
    from qaray_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "k2_layout"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "k2v.cu", out_dir / "libk2v.so"
    cu.write_text((_build.CSRC / "analytic.cu").read_text() + APPENDIX)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}",
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def sass_counts(so):
    """{function: instructions up to its first unpredicated EXIT} of the
    library's SASS (cuobjdump -sass), NOPs left out, and {function:
    [shared-memory loads, of them 64- or 128-bit]} over the same
    instructions."""
    from qaray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, lds, name, count, done = {}, {}, None, 0, False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, count, done = m.group(1), 0, False
            counts[name], lds[name] = 0, [0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if name is None or done or not m:
            continue
        op = m.group(1).strip()
        if op.startswith("NOP"):
            continue
        count += 1
        counts[name] = count
        mnemonic = op.split()[1] if op.startswith("@") else op.split()[0]
        if mnemonic.startswith("LDS"):
            lds[name][0] += 1
            lds[name][1] += int(".64" in mnemonic or ".128" in mnemonic)
        if op == "EXIT":
            done = True
    return counts, lds


def probe_costs(counts):
    """Instructions of one test and one attribute block of each kind: the
    probe of two less the probe of one, less the probe's own additions."""
    out = {}
    for probe in PROBES:
        one, two = (counts[f"probe_{probe}_{k}"] for k in (1, 2))
        out[probe] = two - one - PROBE_EXTRA[probe.split("_")[1]]
    return out


def issue_floor(t_all, kinds, winners, hit, cost, want_uv, clock_hz, sms):
    """(kept, parent) issue-rate floors in ms: per warp of 32 rays in
    launch order, the tests of every primitive and the attribute blocks
    (none for want_uv None, K2a), at 4 warp instructions a clock an SM."""
    n = t_all.shape[0]
    pad = (-n) % 32
    uv = "uv" if want_uv else "nouv"
    test = sum(cost["sphere_tests" if k == 0 else "plane_tests"]
               for k in kinds)
    warps = (n + pad) // 32
    sphere = torch.tensor([k == 0 for k in kinds], device=t_all.device)

    def per_warp(mask):
        m = torch.nn.functional.pad(mask, (0, pad)).view(warps, 32)
        return m.any(1).sum().item()

    scale = 1e3 / (4 * sms * clock_hz)
    if want_uv is None:
        return warps * test * scale, warps * test * scale
    win_sphere = hit & sphere[winners.long()]
    kept = (warps * test + per_warp(win_sphere) * cost[f"sphere_{uv}"]
            + per_warp(hit & ~win_sphere) * cost[f"plane_{uv}"])
    # The parent: a new winner at primitive k wherever t_k < the best of
    # primitives 0..k-1.
    best = torch.full((n,), 1e30, device=t_all.device)
    parent = warps * test
    for k, kind in enumerate(kinds):
        new = t_all[:, k] < best
        best = torch.where(new, t_all[:, k], best)
        parent += per_warp(new) * cost[f"{'sphere' if kind == 0 else 'plane'}"
                                       f"_{uv}"]
    return kept * scale, parent * scale


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import qaray_tpu_torch
    from qaray_tpu_torch.ops import _build, analytic
    from qaray_tpu_torch.ops import intersect as I
    from qaray_tpu_torch.scene.compiler import compile_scene
    from qaray_tpu_torch.scene.xml_parser import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(qaray_tpu_torch.__file__))), "tests", "assets")
    s_arr, s_meta = compile_scene(load_scene(os.path.join(
        assets, "softdof_scene.xml")), device="cuda")
    prims = s_arr.analytic
    kinds = prims.kind.tolist()
    host_tab, host_kinds = prims.table.cpu(), prims.kind.cpu()
    so, report = build()
    lib = ctypes.CDLL(str(so))
    variant_fn = _build.bind(lib, "qr_k2_variant", "iiipp" + "ppipppi"
                             + "p" * 8 + "p")
    counts, lds = sass_counts(so)
    cost = probe_costs(counts)
    out = {"card": card, "sm_clock_hz": clock, "sms": sms,
           "probe_costs": cost,
           "kernels": {k: v for k, v in counts.items()
                       if not k.startswith("probe")},
           "shared_loads": {k: v for k, v in lds.items()
                            if not k.startswith("probe")},
           "ptxas": [line.strip() for line in report.splitlines()
                     if "registers" in line or "spill" in line
                     or "Function properties" in line]}
    print(f"  instructions: {json.dumps(cost)}", flush=True)
    for k, v in sorted(out["kernels"].items()):
        print(f"  {k}: {v} instructions, shared loads {lds[k][0]} "
              f"({lds[k][1]} wide)", flush=True)

    variants = {**VARIANTS, **K2A_SPLIT}

    def run(name, full, want_uv, p, d):
        if name == "kept":
            if not full:
                return analytic.closest(p, d, prims)
            return analytic.closest_full(p, d, prims, want_uv=want_uv)
        outs = analytic._full_launch(
            {"full": lambda *a: variant_fn(
                variants[name], int(full), int(want_uv),
                host_tab.data_ptr(), host_kinds.data_ptr(), *a[:-2],
                a[-1])}, p, d, prims, want_uv,
            torch.cuda.current_stream().cuda_stream, name)
        return (outs["t"], outs["prim_idx"]) if not full else outs

    kernel_of = {"kept": ("closest_kernel", "closest_full_kernel"),
                 "param table": ("param_kernel", "param_kernel"),
                 "scalar rows": ("scalar_kernel", "scalar_kernel"),
                 "global rows": ("global_kernel", "global_kernel"),
                 "ldg rows": ("ldg_kernel", "ldg_kernel"),
                 "parent K2a": ("k2a_parent", None),
                 "parent + float4 rows": ("k2a_rows", None),
                 "parent + 64-bit index": ("k2a_wide", None),
                 "parent + launch bounds": ("k2a_bounds", None),
                 "parent + ClosestParams": ("k2a_struct", None)}
    for n in K2_SIZES:
        p, d, _ = shadow_rays(n)
        sets = {"random": (p, d)}
        for b, rays in enumerate(batch_rays(s_arr, s_meta, n)):
            sets[f"bounce{b}"] = rays
        for what, (pr, dr) in sets.items():
            t_all = I.intersect_analytic_t(pr, dr, prims)
            ref = analytic.closest_full(pr, dr, prims)
            hit = ref["t"] < 1e29
            row = {}
            for full, want_uv, tag in ((False, False, "K2a"),
                                       (True, True, "K2b"),
                                       (True, False, "K2b no uv")):
                names = list(VARIANTS) + ([] if full else list(K2A_SPLIT))
                want = run("kept", full, want_uv, pr, dr)
                for name in names:
                    got = run(name, full, want_uv, pr, dr)
                    same = (all(torch.equal(a, b) for a, b in zip(got, want))
                            if not full else all(torch.equal(got[k], want[k])
                                                 for k in want))
                    if not same:
                        raise SystemExit(f"{tag} {name}, {what} {n} rays: "
                                         "outputs differ from the kept "
                                         "kernel's")
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    kname = kernel_of[name][int(full)]
                    times[name].append(device_ms(
                        lambda: run(name, full, want_uv, pr, dr), kname))
                row[tag] = times
                kept_floor, parent_floor = issue_floor(
                    t_all, kinds, ref["prim_idx"], hit, cost,
                    want_uv if full else None, clock, sms)
                row[f"{tag} issue floor ms"] = {"kept": kept_floor,
                                                "parent": parent_floor}
                for name, t in times.items():
                    print(f"  {tag} {what} {n} rays, {name}: {t[0]:.5f} / "
                          f"{t[1]:.5f} ms", flush=True)
            row["hit_share"] = hit.float().mean().item()
            out[f"{what}_{n}"] = row
            floors = {k: v for k, v in row.items() if "floor" in k}
            print(f"  {what} {n}: issue floors {json.dumps(floors)}",
                  flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
