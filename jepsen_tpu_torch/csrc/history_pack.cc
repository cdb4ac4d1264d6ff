// The native history packer: the O(R x W) slot walk of
// jepsen_tpu_torch/lin/prepare.py (_pack_events_py) in C++, the port's own
// copy of the JAX package's packer with the same C ABI. Its tables are the
// Python walk's, bit for bit (slot allocation is the same LIFO free list);
// tests/test_torch_pack.py holds them against both packages' walks.
//
// A host library, not a device kernel: built by the host compiler
// (g++ -O2 -shared -fPIC -std=c++17) at first use through
// jepsen_tpu_torch/_build.py, loaded with ctypes by
// jepsen_tpu_torch/native_ext.py.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Returns 0 on success; -1 = concurrency window exceeded max_window
// (*out_window = offending history position); -2 = bad input.
//
// Inputs are per logical op (n_ops of them, pre-sorted by invoke_pos):
//   invoke_pos[i], return_pos[i] (-1 if crashed), f_id/v0/v1[i] (ignored
//   when fill_fv == 0).
// Outputs are caller-allocated with R = #ops having return_pos >= 0:
//   ret_slot[R], ret_op[R], active[R*max_window] (u8),
//   slot_f[R*max_window], slot_v[R*max_window*2], slot_op[R*max_window],
//   *out_window = max slots in use.
int jtpu_pack_events(int32_t n_ops,
                     const int32_t* invoke_pos,
                     const int32_t* return_pos,
                     const int32_t* f_id,
                     const int32_t* v0,
                     const int32_t* v1,
                     int32_t nil_value,
                     int32_t max_window,
                     int32_t fill_fv,
                     int32_t R,
                     int32_t* ret_slot,
                     int32_t* ret_op,
                     uint8_t* active,
                     int32_t* slot_f,
                     int32_t* slot_v,
                     int32_t* slot_op,
                     int32_t* out_window) {
  if (n_ops < 0 || max_window <= 0 || R < 0) return -2;

  // Event stream over op endpoints: (pos, kind, op). kind 0 = invoke
  // sorts before kind 1 = return at equal positions, matching the Python
  // tuple sort (positions are distinct in real histories anyway).
  struct Ev {
    int32_t pos;
    int32_t kind;
    int32_t op;
  };
  std::vector<Ev> events;
  events.reserve(static_cast<size_t>(n_ops) * 2);
  int32_t r_expected = 0;
  for (int32_t i = 0; i < n_ops; ++i) {
    events.push_back({invoke_pos[i], 0, i});
    if (return_pos[i] >= 0) {
      events.push_back({return_pos[i], 1, i});
      ++r_expected;
    }
  }
  if (r_expected != R) return -2;
  std::sort(events.begin(), events.end(), [](const Ev& a, const Ev& b) {
    if (a.pos != b.pos) return a.pos < b.pos;
    if (a.kind != b.kind) return a.kind < b.kind;
    return a.op < b.op;
  });

  // LIFO free list identical to the Python `free` stack: initialized so
  // the first pop yields slot 0, frees push back for immediate reuse.
  std::vector<int32_t> free_slots;
  free_slots.reserve(max_window);
  for (int32_t s = max_window - 1; s >= 0; --s) free_slots.push_back(s);

  std::vector<int32_t> slot_of(n_ops, -1);
  // cur_op[s] = op occupying slot s, or -1. Iterating slots 0..max_used
  // reproduces the Python dict's insertion-order row fill superset: the
  // row contents are identical (order within a row doesn't matter, each
  // slot writes its own column).
  std::vector<int32_t> cur_op(max_window, -1);
  int32_t max_used = 0;
  int32_t r = 0;
  const int32_t W = max_window;

  for (const Ev& e : events) {
    if (e.kind == 0) {
      if (free_slots.empty()) {
        *out_window = e.pos;
        return -1;
      }
      int32_t s = free_slots.back();
      free_slots.pop_back();
      slot_of[e.op] = s;
      cur_op[s] = e.op;
      if (s + 1 > max_used) max_used = s + 1;
    } else {
      int32_t s = slot_of[e.op];
      ret_slot[r] = s;
      ret_op[r] = e.op;
      uint8_t* act_row = active + static_cast<size_t>(r) * W;
      int32_t* f_row = slot_f + static_cast<size_t>(r) * W;
      int32_t* v_row = slot_v + static_cast<size_t>(r) * W * 2;
      int32_t* op_row = slot_op + static_cast<size_t>(r) * W;
      for (int32_t slot = 0; slot < max_used; ++slot) {
        int32_t occ = cur_op[slot];
        if (occ < 0) continue;
        act_row[slot] = 1;
        op_row[slot] = occ;
        if (fill_fv) {
          f_row[slot] = f_id[occ];
          v_row[slot * 2] = v0[occ];
          v_row[slot * 2 + 1] = v1[occ];
        }
      }
      ++r;
      cur_op[s] = -1;
      slot_of[e.op] = -1;
      free_slots.push_back(s);
    }
  }
  (void)nil_value;
  *out_window = max_used;
  return 0;
}

}  // extern "C"
