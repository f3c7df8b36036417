// The launch records' C interface (the records themselves: common.cuh).
// Replaces no TPU kernel: it reads what the other kernels' launch sites
// noted, for the budget check of chip_smoke.py's tune phase.

#include "common.cuh"

// on != 0: clear the records and note every launch from now on; 0: stop
extern "C" int apex1_launch_record(int on) {
  g_launch_recording = on != 0;
  if (on) g_launch_count = 0;
  return 0;
}

// copy up to `most` records into out, six ints each (static shared
// memory, registers a thread, the most threads a block, dynamic shared
// memory, threads a block, local memory bytes a thread); returns how
// many were noted
extern "C" int apex1_launch_records(int* out, int most) {
  const int n = g_launch_count < most ? g_launch_count : most;
  for (int i = 0; i < n; ++i) {
    const LaunchRecord& r = g_launch_records[i];
    const int v[6] = {r.static_smem, r.regs,    r.max_threads,
                      r.dyn_smem,    r.threads, r.local_bytes};
    for (int j = 0; j < 6; ++j) out[6 * i + j] = v[j];
  }
  return g_launch_count;
}
