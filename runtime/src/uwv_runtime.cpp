// uwv_runtime — native host-side runtime for the banked filter framework.
//
// The reference library is driven by a ROCK component that feeds timestamped
// sensor callbacks one at a time (SURVEY.md §3.6). The banked execution model
// instead wants DENSE, fixed-shape schedules: one lax.scan over ticks with
// per-sensor validity masks. This module is the data-loader between the two
// worlds: it converts irregular multi-rate event streams into the packed
// tick grid consumed by models/pose_driver.py — the host-side work that
// would otherwise serialize Python in the ingest path.
//
// It also provides a native DelayedStates ring buffer mirroring
// pose_estimation::DelayedStates<T> (pushState / getClosestState /
// fromSeconds semantics) for host-side out-of-sequence bookkeeping.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Event-stream → dense tick schedule packer.
//
// timestamps [n_events] (µs), sensor_ids [n_events] in [0, n_sensors),
// payloads [n_events * payload_stride] row-major (each event uses the first
// sensor_dims[id] entries of its row).
//
// Outputs (caller-allocated):
//   out_values [n_sensors * n_ticks * payload_stride]
//   out_valid  [n_sensors * n_ticks]
//
// Events map to tick floor((ts - t0)/dt); within a (sensor, tick) cell the
// LATEST event wins (the reference keeps only the newest cached input, e.g.
// rotation_rate at src/PoseUKF.cpp:492-496). Events outside [t0, t0+n*dt)
// are dropped. Returns the number of dropped events, or -1 on bad args.
int64_t uwv_pack_schedule(const int64_t* timestamps, const int32_t* sensor_ids,
                          const double* payloads, int64_t n_events,
                          int32_t payload_stride, const int32_t* sensor_dims,
                          int32_t n_sensors, int64_t t0_us, int64_t dt_us,
                          int64_t n_ticks, double* out_values,
                          uint8_t* out_valid) {
  if (dt_us <= 0 || n_ticks < 0 || n_sensors <= 0 || payload_stride <= 0)
    return -1;
  std::memset(out_valid, 0, static_cast<size_t>(n_sensors) * n_ticks);
  std::memset(out_values, 0,
              sizeof(double) * static_cast<size_t>(n_sensors) * n_ticks *
                  payload_stride);
  // Track the winning timestamp per cell so out-of-order input streams still
  // resolve to latest-wins deterministically.
  std::vector<int64_t> winner(static_cast<size_t>(n_sensors) * n_ticks,
                              std::numeric_limits<int64_t>::min());
  int64_t dropped = 0;
  for (int64_t e = 0; e < n_events; ++e) {
    const int32_t sid = sensor_ids[e];
    if (sid < 0 || sid >= n_sensors) {
      ++dropped;
      continue;
    }
    const int64_t rel = timestamps[e] - t0_us;
    if (rel < 0) {
      ++dropped;
      continue;
    }
    const int64_t tick = rel / dt_us;
    if (tick >= n_ticks) {
      ++dropped;
      continue;
    }
    const size_t cell = static_cast<size_t>(sid) * n_ticks + tick;
    if (timestamps[e] < winner[cell]) continue;  // an even newer event won
    winner[cell] = timestamps[e];
    out_valid[cell] = 1;
    const int32_t dim = sensor_dims[sid];
    std::memcpy(out_values + cell * payload_stride,
                payloads + static_cast<size_t>(e) * payload_stride,
                sizeof(double) * std::min(dim, payload_stride));
  }
  return dropped;
}

// ---------------------------------------------------------------------------
// Forward-fill helper: for input-type sensors (gyro, efforts) the filter
// uses the LAST received value on every tick, not just ticks with fresh
// events. In-place over the packer's output for one sensor row.
void uwv_forward_fill(double* values, uint8_t* valid, int64_t n_ticks,
                      int32_t payload_stride, const double* initial) {
  double last[64];
  const int32_t d = payload_stride > 64 ? 64 : payload_stride;
  std::memcpy(last, initial, sizeof(double) * d);
  for (int64_t t = 0; t < n_ticks; ++t) {
    double* row = values + static_cast<size_t>(t) * payload_stride;
    if (valid[t]) {
      std::memcpy(last, row, sizeof(double) * d);
    } else {
      std::memcpy(row, last, sizeof(double) * d);
      valid[t] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// DelayedStates<T> ring buffer (pose_estimation semantics):
// pushState(ts, value, cov), getClosestState(ts) -> bool.
struct UwvDelayedStates {
  int64_t capacity;
  int32_t dim;
  int64_t max_delay_us;
  int64_t head = 0;
  int64_t count = 0;
  std::vector<int64_t> ts;
  std::vector<double> values;  // [capacity * dim]
  std::vector<double> covs;    // [capacity * dim * dim]
};

void* uwv_delayed_states_new(int64_t capacity, int32_t dim,
                             double maximum_delay_s) {
  // capacity 0 would make push() take `% 0` (SIGFPE) after an OOB write;
  // negative sizes would abort inside vector::resize across the C ABI —
  // return NULL and let the binding raise instead
  if (capacity <= 0 || dim <= 0) return nullptr;
  auto* b = new UwvDelayedStates();
  b->capacity = capacity;
  b->dim = dim;
  b->max_delay_us =
      static_cast<int64_t>((maximum_delay_s < 0 ? -maximum_delay_s
                                                : maximum_delay_s) *
                           1e6);
  b->ts.resize(capacity);
  b->values.resize(static_cast<size_t>(capacity) * dim);
  b->covs.resize(static_cast<size_t>(capacity) * dim * dim);
  return b;
}

void uwv_delayed_states_free(void* h) {
  delete static_cast<UwvDelayedStates*>(h);
}

void uwv_delayed_states_push(void* h, int64_t ts_us, const double* value,
                             const double* cov) {
  auto* b = static_cast<UwvDelayedStates*>(h);
  const int64_t i = b->head;
  b->ts[i] = ts_us;
  std::memcpy(&b->values[i * b->dim], value, sizeof(double) * b->dim);
  std::memcpy(&b->covs[static_cast<size_t>(i) * b->dim * b->dim], cov,
              sizeof(double) * b->dim * b->dim);
  b->head = (i + 1) % b->capacity;
  if (b->count < b->capacity) ++b->count;
}

int32_t uwv_delayed_states_closest(void* h, int64_t ts_us, double* out_value,
                                   double* out_cov) {
  auto* b = static_cast<UwvDelayedStates*>(h);
  if (b->count == 0) return 0;
  int64_t best = -1;
  int64_t best_dist = std::numeric_limits<int64_t>::max();
  for (int64_t i = 0; i < b->count; ++i) {
    const int64_t d = std::llabs(b->ts[i] - ts_us);
    if (d < best_dist) {
      best_dist = d;
      best = i;
    }
  }
  if (best < 0 || best_dist > b->max_delay_us) return 0;
  std::memcpy(out_value, &b->values[best * b->dim], sizeof(double) * b->dim);
  std::memcpy(out_cov, &b->covs[static_cast<size_t>(best) * b->dim * b->dim],
              sizeof(double) * b->dim * b->dim);
  return 1;
}

int64_t uwv_from_seconds(double seconds) {
  return static_cast<int64_t>(seconds * 1e6 + (seconds >= 0 ? 0.5 : -0.5));
}

// ---------------------------------------------------------------------------
// Streaming ingest: incremental event → fixed-size tick-window packer.
//
// uwv_pack_schedule above is a one-shot batch call; an online estimator
// instead receives sensor events continuously and steps the device one
// window (a fixed number of ticks) at a time. This streamer keeps dense
// per-window staging buffers for every window that still has in-flight
// events (bounded by the source's real lookahead), applies latest-wins
// per (sensor, tick) cell incrementally, and releases windows IN ORDER
// once the push watermark (the newest timestamp seen) passes their end —
// so the Python loop can overlap device compute on window k with native
// ingest of window k+1. Events for already-released windows are late and
// counted as dropped, like the reference's single-slot input caches that
// only keep the newest value (src/PoseUKF.cpp:492-496).

namespace {
struct UwvStreamWindow {
  std::vector<double> values;   // [n_sensors * ticks * stride]
  std::vector<uint8_t> valid;   // [n_sensors * ticks]
  std::vector<int64_t> winner;  // latest-wins timestamps per cell
};
}  // namespace

struct UwvStream {
  int32_t n_sensors;
  int32_t payload_stride;
  std::vector<int32_t> dims;
  int64_t t0_us;
  int64_t dt_us;
  int64_t window_ticks;
  int64_t next_window = 0;  // next window index to release
  int64_t watermark_us = std::numeric_limits<int64_t>::min();
  int64_t dropped = 0;
  std::map<int64_t, UwvStreamWindow> staged;
};

void* uwv_stream_new(int32_t n_sensors, int32_t payload_stride,
                     const int32_t* sensor_dims, int64_t t0_us, int64_t dt_us,
                     int64_t window_ticks) {
  if (n_sensors <= 0 || payload_stride <= 0 || dt_us <= 0 || window_ticks <= 0)
    return nullptr;
  auto* s = new UwvStream();
  s->n_sensors = n_sensors;
  s->payload_stride = payload_stride;
  s->dims.assign(sensor_dims, sensor_dims + n_sensors);
  s->t0_us = t0_us;
  s->dt_us = dt_us;
  s->window_ticks = window_ticks;
  return s;
}

void uwv_stream_free(void* h) { delete static_cast<UwvStream*>(h); }

// Stage a batch of (possibly out-of-order) events. Returns the number
// dropped IN THIS CALL (bad sensor id, before t0, or for a window that was
// already released).
int64_t uwv_stream_push(void* h, const int64_t* timestamps,
                        const int32_t* sensor_ids, const double* payloads,
                        int64_t n_events) {
  auto* s = static_cast<UwvStream*>(h);
  const int64_t win_span = s->dt_us * s->window_ticks;
  int64_t dropped = 0;
  for (int64_t e = 0; e < n_events; ++e) {
    const int32_t sid = sensor_ids[e];
    const int64_t rel = timestamps[e] - s->t0_us;
    if (sid < 0 || sid >= s->n_sensors || rel < 0) {
      ++dropped;
      continue;
    }
    const int64_t w = rel / win_span;
    if (w < s->next_window) {  // window already released: late event
      ++dropped;
      continue;
    }
    auto& win = s->staged[w];
    if (win.valid.empty()) {
      const size_t cells =
          static_cast<size_t>(s->n_sensors) * s->window_ticks;
      win.values.assign(cells * s->payload_stride, 0.0);
      win.valid.assign(cells, 0);
      win.winner.assign(cells, std::numeric_limits<int64_t>::min());
    }
    const int64_t tick = (rel - w * win_span) / s->dt_us;
    const size_t cell = static_cast<size_t>(sid) * s->window_ticks + tick;
    if (timestamps[e] < win.winner[cell]) continue;
    win.winner[cell] = timestamps[e];
    win.valid[cell] = 1;
    std::memcpy(win.values.data() + cell * s->payload_stride,
                payloads + static_cast<size_t>(e) * s->payload_stride,
                sizeof(double) *
                    std::min(s->dims[sid], s->payload_stride));
    if (timestamps[e] > s->watermark_us) s->watermark_us = timestamps[e];
  }
  s->dropped += dropped;
  return dropped;
}

// 1 if the next in-order window can be released (the watermark has passed
// its end), else 0.
int32_t uwv_stream_ready(void* h) {
  auto* s = static_cast<UwvStream*>(h);
  const int64_t win_span = s->dt_us * s->window_ticks;
  const int64_t end = s->t0_us + (s->next_window + 1) * win_span;
  return s->watermark_us >= end ? 1 : 0;
}

// Release the next in-order window into caller buffers
// (out_values [n_sensors * window_ticks * payload_stride],
//  out_valid  [n_sensors * window_ticks]). Windows with no staged events
// release as all-invalid tick grids. ``force`` releases even when the
// watermark has not passed the window end (stream shutdown / flush).
// Returns the released window index, or -1 if not ready and not forced.
int64_t uwv_stream_pop(void* h, int32_t force, double* out_values,
                       uint8_t* out_valid) {
  auto* s = static_cast<UwvStream*>(h);
  if (!force && !uwv_stream_ready(h)) return -1;
  if (force && s->staged.empty() &&
      s->watermark_us < s->t0_us + (s->next_window * s->dt_us * s->window_ticks))
    return -1;  // nothing staged and nothing behind the watermark: done
  const int64_t w = s->next_window;
  const size_t cells = static_cast<size_t>(s->n_sensors) * s->window_ticks;
  auto it = s->staged.find(w);
  if (it == s->staged.end()) {
    std::memset(out_values, 0, sizeof(double) * cells * s->payload_stride);
    std::memset(out_valid, 0, cells);
  } else {
    std::memcpy(out_values, it->second.values.data(),
                sizeof(double) * cells * s->payload_stride);
    std::memcpy(out_valid, it->second.valid.data(), cells);
    s->staged.erase(it);
  }
  ++s->next_window;
  return w;
}

// Total events dropped since creation (late, bad id, or before t0).
int64_t uwv_stream_dropped(void* h) {
  return static_cast<UwvStream*>(h)->dropped;
}

}  // extern "C"
