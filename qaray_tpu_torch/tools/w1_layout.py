"""W1's design choices measured on one GPU, where its time goes, and its
issue-rate floor from its instruction counts.

    python -m qaray_tpu_torch.tools.w1_layout

The variants, built with nvcc into build/w1_layout/ from copies of
csrc/bvh.cu:
- "kept": the source as it is, with the SASS probes of APPENDIX added at
  its end;
- "shared stack": each thread's stack in shared memory,
  [stack_size][blockDim] refs thread-minor, in place of its own array in
  local memory;
- "64 registers": __launch_bounds__(kThreads, 8), which holds a thread to
  64 registers for 8 blocks an SM.
Each runs at kernel_times.w1_launches' four launches (4o's largest
closest-hit and any-hit launches, 4p's largest closest-hit launch, ico5's
world tree), through ops/bvh_packed's wrapper with its library swapped,
timed twice in turns (forward, then in reverse order) by torch.profiler's
device time, the mean over 20 launches after one that is not counted;
every variant's outputs and work counters are held equal to the kept
kernel's, bit for bit.

Where the time goes, for the kept kernel at each launch: the quantiles and
the largest of a ray's steps (inner nodes and triangle tests), the time of
the launch without its slowest 1 % of rays (by steps) and of those rays
alone (each in launch order), and the share of its slowest 0.1 % of rays
whose direction lies within 1e-7 of parallel to an axis in the space of
some instance (where the slab test leaves that axis unbounded).

The SASS probes count, with cuobjdump -sass, the instructions of the
common path (no leaf child hit) of an instance's root step, with its
transform and without (a world tree's root), of a deeper node step (the
row's load, the two slab tests, the choice of the next node) and of a
triangle test with its take: a probe of two less a probe of one, less the
probe's own add, up to the probe's first unpredicated EXIT (so the IEEE
slow paths of the divisions are not counted). The issue-rate floor of a
launch counts, for each warp of 32 rays in launch order, the root steps of
every instance some lane of it walks, its lanes' largest count of deeper
node steps and of triangle tests (from W1's work counters), at 4 warp
instructions a clock on each SM at the card's maximum SM clock: the
instructions of those paths alone, so a lower bound.

Prints the card's name and power limit and, last, one JSON line.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from qaray_tpu_torch.tools.k2_layout import sass_counts
from qaray_tpu_torch.tools.kernel_times import (
    device_ms,
    ptxas_report,
    w1_launches,
    w1_walked,
    W1_SYMBOLS,
)

APPENDIX = r'''
// ---- SASS probes of W1's common paths (tools/w1_layout.py) ----
namespace {

// An instance's root step with no leaf child hit: the move into object
// space, the reciprocals, both slab tests from the staged record and the
// leaf and push decisions.
__device__ __forceinline__ int probe_root(const float* rec, bool has_xf,
                                          const V3& p, const V3& d,
                                          float t) {
  V3 po = p, dob = d;
  if (has_xf) to_object(rec, p, d, po, dob);
  const bool small[3] = {fabsf(dob.x) < 1e-7f, fabsf(dob.y) < 1e-7f,
                         fabsf(dob.z) < 1e-7f};
  const V3 rcp{small[0] ? 1.0f : 1.0f / dob.x,
               small[1] ? 1.0f : 1.0f / dob.y,
               small[2] ? 1.0f : 1.0f / dob.z};
  const float4* r4 = reinterpret_cast<const float4*>(rec + 12);
  const float4 a = r4[0], b = r4[1], c = r4[2], e = r4[3];
  const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
  const int ref0 = __float_as_int(e.x), ref1 = __float_as_int(e.y);
  float entry0, entry1;
  const bool hit0 = slab(row, po, rcp, small, t, entry0);
  const bool hit1 = slab(row + 6, po, rcp, small, t, entry1);
  const bool leaf = (hit0 && ref0 < 0) || (hit1 && ref1 < 0);
  const bool push = (hit0 && ref0 >= 0 && entry0 < t) ||
                    (hit1 && ref1 >= 0 && entry1 < t);
  return 2 * leaf + push;
}

// A deeper node step with no leaf child hit: the row's load, both slab
// tests and the choice of the next node (the near child, or a pop).
__device__ __forceinline__ int probe_node(const float* pnodes, int ref,
                                          int* stack, int& sp, int top,
                                          const V3& po, const V3& rcp,
                                          const bool* small, float t) {
  const float4* nodes = reinterpret_cast<const float4*>(pnodes);
  const float4 a = __ldg(nodes + 4 * (size_t)ref),
               b = __ldg(nodes + 4 * (size_t)ref + 1),
               c = __ldg(nodes + 4 * (size_t)ref + 2),
               e = __ldg(nodes + 4 * (size_t)ref + 3);
  const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
  const int ref0 = __float_as_int(e.x), ref1 = __float_as_int(e.y);
  float entry0, entry1;
  const bool hit0 = slab(row, po, rcp, small, t, entry0);
  const bool hit1 = slab(row + 6, po, rcp, small, t, entry1);
  const bool push0 = hit0 && ref0 >= 0 && entry0 < t;
  const bool push1 = hit1 && ref1 >= 0 && entry1 < t;
  int next;
  if (push0 && push1) {
    const bool near0 = entry0 < entry1;
    stack[sp < top ? sp : top] = near0 ? ref1 : ref0;
    ++sp;
    next = near0 ? ref0 : ref1;
  } else if (push0 || push1) {
    next = push0 ? ref0 : ref1;
  } else {
    --sp;
    next = stack[sp < top ? sp : top];
  }
  return next + ((hit0 && ref0 < 0) || (hit1 && ref1 < 0));
}

__device__ __forceinline__ float probe_tri(const float4* rows, const V3& p,
                                           const V3& d, float t_best) {
  const float4 r0 = __ldg(rows), r1 = __ldg(rows + 1), r2 = __ldg(rows + 2);
  float t, a, b, c;
  bool fr;
  const bool take = tri_test(r0, r1, r2, p, d, t_best, t, a, b, c, fr) &&
                    t < t_best;
  return take ? t + a + b + c + (fr ? 1.0f : 0.0f) : t_best;
}

// kWhat: 0 root step with a transform, 1 a world tree's root step, 2 a
// node step, 3 a triangle test; kCopies of it on the same ray.
template <int kWhat, int kCopies>
__global__ void probe_kernel(const float* recs, const float* pnodes,
                             const float* ltri, const float* ray,
                             float* out) {
  __shared__ __align__(16) float s_rec[2 * kRec];
  if (threadIdx.x < 2 * kRec) s_rec[threadIdx.x] = recs[threadIdx.x];
  __syncthreads();
  int stack[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) stack[k] = (int)ray[8 + k];
  const V3 p{ray[0], ray[1], ray[2]}, d{ray[3], ray[4], ray[5]};
  const bool small[3] = {fabsf(d.x) < 1e-7f, fabsf(d.y) < 1e-7f,
                         fabsf(d.z) < 1e-7f};
  const V3 rcp{small[0] ? 1.0f : 1.0f / d.x, small[1] ? 1.0f : 1.0f / d.y,
               small[2] ? 1.0f : 1.0f / d.z};
  float acc = 0.0f;
  int sp = 4, ref = (int)ray[7];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    if (kWhat == 0 || kWhat == 1)
      acc += (float)probe_root(s_rec + kRec * k, kWhat == 0, p, d, ray[6]);
    else if (kWhat == 2)
      ref = probe_node(pnodes, ref, stack, sp, 7, p, rcp, small, ray[6]);
    else
      acc += probe_tri(reinterpret_cast<const float4*>(ltri) + 3 * k, p, d,
                       ray[6]);
  }
  out[threadIdx.x] = acc + (float)(ref + sp);
}

}  // namespace

void* qr_w1_probe_keep[] = {
    (void*)probe_kernel<0, 1>, (void*)probe_kernel<0, 2>,
    (void*)probe_kernel<1, 1>, (void*)probe_kernel<1, 2>,
    (void*)probe_kernel<2, 1>, (void*)probe_kernel<2, 2>,
    (void*)probe_kernel<3, 1>, (void*)probe_kernel<3, 2>};
'''

# Each thread's stack in shared memory, [stack_size][blockDim] refs.
SHARED_STACK = (
    ("  int stack[QR_BVH_STACK];\n",
     "  int* stack = reinterpret_cast<int*>(\n"
     "      smem + kRec * (P.n_inst < kChunk ? P.n_inst : kChunk)) +\n"
     "      threadIdx.x;\n"),
    ("      stack[sp < top ? sp : top] = near0 ? ref1 : ref0;",
     "      stack[(sp < top ? sp : top) * blockDim.x] = near0 ? ref1 : ref0;"),
    ("      next = stack[sp < top ? sp : top];",
     "      next = stack[(sp < top ? sp : top) * blockDim.x];"),
    ("  const size_t smem = sizeof(float) * (size_t)kRec * chunk;",
     "  const size_t smem =\n      sizeof(float) * ((size_t)kRec * chunk + "
     "(size_t)stack_size * kThreads);"),
)
REG64 = (("__launch_bounds__(kThreads) bvh_kernel",
          "__launch_bounds__(kThreads, 8) bvh_kernel"),)
PROBES = ("root", "world_root", "node", "tri")
# The probe's own addition a copy (acc += ..., or the node probe's + of
# its leaf flag), taken off the difference.
PROBE_EXTRA = {"root": 1, "world_root": 1, "node": 1, "tri": 1}


def build(name, text):
    """nvcc of `text` (a variant of csrc/bvh.cu) into
    build/w1_layout/lib<name>.so; returns (path, nvcc's report)."""
    from qaray_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "w1_layout"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}",
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                         f"{proc.stderr}")
    return so, proc.stdout + proc.stderr


def variant_sources():
    """{variant: source}: the kept source with APPENDIX, the shared-stack
    variant and the 64-register one."""
    from qaray_tpu_torch.ops import _build

    src = (_build.CSRC / "bvh.cu").read_text()

    def edit(pairs):
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"csrc/bvh.cu no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    return {"kept": src + APPENDIX, "shared stack": edit(SHARED_STACK),
            "64 registers": edit(REG64)}


def probe_costs(counts):
    """Instructions of each probe's path: the probe of two less the probe
    of one, less the probe's own addition."""
    out = {}
    for k, what in enumerate(PROBES):
        one, two = (counts[next(f for f in counts
                                if f"probe_kernelILi{k}ELi{c}E" in f)]
                    for c in (1, 2))
        out[what] = two - one - PROBE_EXTRA[what]
    return out


def issue_floor(work, walked, world, cost, clock_hz, sms):
    """Issue-rate floor (ms) of a launch from its work counters [n, 2]
    and the instances each ray walked [n] (root steps: one each)."""
    n = work.shape[0]
    pad = (-n) % 32
    w = torch.nn.functional.pad(work.long(), (0, 0, 0, pad)).view(-1, 32, 2)
    roots = torch.nn.functional.pad(walked.long(), (0, pad)).view(-1, 32)
    deeper = (w[..., 0] - roots).clamp_min(0)
    root_cost = cost["world_root" if world else "root"]
    instr = (roots.max(1).values * root_cost
             + deeper.max(1).values * cost["node"]
             + w[..., 1].max(1).values * cost["tri"]).sum().item()
    return instr * 1e3 / (4 * sms * clock_hz)


def near_parallel(launch, rays):
    """Whether each of `rays` (indices) has a direction within 1e-7 of
    parallel to an axis in the space of some instance of the launch (in
    world space for a world tree)."""
    d = launch[1][rays]
    xf = launch[4][3]
    if xf is None:
        return (d.abs() < 1e-7).any(1)
    dob = torch.einsum("ikl,nl->nik", xf[:, :9].reshape(-1, 3, 3), d)
    return (dob.abs() < 1e-7).any(2).any(1)


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import qaray_tpu_torch
    from qaray_tpu_torch.ops import _build, bvh_packed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"card": card, "max_sm_clock_hz": clock_hz, "sms": sms}
    fns, sos = {}, {}
    for name, text in variant_sources().items():
        sos[name], report = build(name.replace(" ", "_"), text)
        fns[name] = _build.bind(ctypes.CDLL(str(sos[name])), "qr_bvh_walk",
                                "ppppppppiiiiipppppppp")
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and "bvh_kernel" in line:
                print(f"  {name}: {line.split()[-1]}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}",
                      flush=True)
    counts, _ = sass_counts(sos["kept"])
    cost = probe_costs(counts)
    out["probe_instructions"] = cost
    print(f"  instructions a common path: {json.dumps(cost)}", flush=True)
    saved = bvh_packed._lib(False)
    out["ptxas_kept"] = ptxas_report("bvh", W1_SYMBOLS)

    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(qaray_tpu_torch.__file__))), "tests", "assets")
    launches = w1_launches(assets)

    def run(name, launch, work=None, rays=None):
        bvh_packed._fns[False] = (fns[name], bvh_packed.STACK_CAP)
        p, d, t, occ_in, tabs, kw = launch
        if rays is not None:
            p, d, t = (x[rays].contiguous() for x in (p, d, t))
            occ_in = None if occ_in is None else occ_in[rays].contiguous()
        kw = {k: v for k, v in kw.items() if k != "plain"}
        if occ_in is None:
            return bvh_packed.closest(p, d, t, *tabs, work=work, **kw)
        return (bvh_packed.occluded(p, d, t, occ_in, *tabs, work=work,
                                    **kw), )

    try:
        for what, launch in launches.items():
            n = launch[0].shape[0]
            row, works = {}, {}
            for name in fns:
                works[name] = torch.zeros((n, 2), dtype=torch.int32,
                                          device="cuda")
                res = run(name, launch, works[name])
                if name == "kept":
                    kept = res
                elif not (all(torch.equal(a, b) for a, b in zip(kept, res))
                          and torch.equal(works[name], works["kept"])):
                    raise SystemExit(f"{name} differs from the kept kernel "
                                     f"at {what}")
            for name in list(fns) + list(fns)[::-1]:
                row.setdefault(name, []).append(device_ms(
                    lambda: run(name, launch), "bvh_kernel"))
            steps = works["kept"].sum(1)
            order = torch.argsort(steps, descending=True)
            rest = torch.sort(order[n // 100:]).values  # in launch order
            slowest = torch.sort(order[:n // 100]).values
            q = torch.tensor([0.5, 0.9, 0.99, 0.999], device="cuda")
            row["steps_q50_q90_q99_q999"] = torch.quantile(
                steps.double(), q.double()).tolist()
            row["steps_max"] = int(steps.max())
            row["ms_without_slowest_1pct"] = device_ms(
                lambda: run("kept", launch, rays=rest), "bvh_kernel")
            row["ms_slowest_1pct_alone"] = device_ms(
                lambda: run("kept", launch, rays=slowest), "bvh_kernel")
            row["slowest_0.1pct_near_parallel_share"] = near_parallel(
                launch, order[:max(n // 1000, 1)]).double().mean().item()
            tabs = launch[4]
            walked = (w1_walked(launch) if launch[3] is not None else
                      torch.full((n,), tabs[2].numel(), device="cuda"))
            row["issue_floor_ms"] = issue_floor(
                works["kept"], walked, tabs[3] is None, cost, clock_hz, sms)
            row["stack_size"] = launch[5]["stack_size"]
            out[what] = row
            print(f"  {what}: {json.dumps(row)}", flush=True)
    finally:
        bvh_packed._fns[False] = saved
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
