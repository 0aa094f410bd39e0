// Odometry ring buffer: timestamped IMU/encoder sample store with
// time-range extraction into fixed-capacity windows.
//
// The port's copy of vieo_slam_tpu/native/odom_buffer.cc (the reference's
// Tracking::CacheOdom odometry lists under mMutexOdom): the host ingests
// high-rate odometry off the critical path and serves padded,
// mask-annotated windows to the preintegration.  Built with g++ at first
// use by vieo_slam_tpu_torch/io/odom_ring.py and bound with ctypes.
//
// C ABI; single producer, many consumers: a fixed ring, a monotonically
// increasing write index, and reads that snapshot the committed range.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Sample {
  double t;
  float v[6];  // gyro xyz + acc xyz (or wheel speeds for encoders)
};

struct Ring {
  Sample* data;
  int64_t capacity;
  std::atomic<int64_t> committed;  // total samples ever written
};

}  // namespace

extern "C" {

void* odom_ring_create(int64_t capacity) {
  Ring* r = new Ring();
  r->data = new Sample[capacity];
  r->capacity = capacity;
  r->committed.store(0, std::memory_order_release);
  return r;
}

void odom_ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  delete[] r->data;
  delete r;
}

// Push one sample (single producer). Timestamps must be monotonic.
void odom_ring_push(void* h, double t, const float* v6) {
  Ring* r = static_cast<Ring*>(h);
  int64_t n = r->committed.load(std::memory_order_relaxed);
  Sample& s = r->data[n % r->capacity];
  s.t = t;
  std::memcpy(s.v, v6, 6 * sizeof(float));
  r->committed.store(n + 1, std::memory_order_release);
}

// Bulk push (amortizes the Python boundary on file replay).
void odom_ring_push_bulk(void* h, const double* ts, const float* v6s,
                         int64_t count) {
  Ring* r = static_cast<Ring*>(h);
  int64_t n = r->committed.load(std::memory_order_relaxed);
  for (int64_t i = 0; i < count; ++i) {
    Sample& s = r->data[(n + i) % r->capacity];
    s.t = ts[i];
    std::memcpy(s.v, v6s + 6 * i, 6 * sizeof(float));
  }
  r->committed.store(n + count, std::memory_order_release);
}

int64_t odom_ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return std::min(r->committed.load(std::memory_order_acquire),
                  r->capacity);
}

double odom_ring_latest_time(void* h) {
  Ring* r = static_cast<Ring*>(h);
  int64_t n = r->committed.load(std::memory_order_acquire);
  if (n == 0) return -1.0;
  return r->data[(n - 1) % r->capacity].t;
}

// Extract the window covering (t0, t1]: integration intervals clipped to
// the range (the reference's boundary-interpolation semantics for
// midpoint preintegration). Outputs are fixed-capacity padded arrays:
//   vals [cap, 6], dts [cap], mask [cap] (uint8)
// Returns the number of valid intervals (may exceed cap: caller should
// re-window, value is clamped into outputs).
int64_t odom_ring_window(void* h, double t0, double t1, int64_t cap,
                         float* vals, float* dts, uint8_t* mask) {
  Ring* r = static_cast<Ring*>(h);
  int64_t n = r->committed.load(std::memory_order_acquire);
  int64_t lo = std::max<int64_t>(0, n - r->capacity);

  std::memset(vals, 0, sizeof(float) * 6 * cap);
  std::memset(dts, 0, sizeof(float) * cap);
  std::memset(mask, 0, sizeof(uint8_t) * cap);
  if (n - lo < 2) return 0;

  // Binary search for the first sample with t > t0, then step back one
  // so the boundary interval [t0, t_first] is covered.
  int64_t a = lo, b = n;
  while (a < b) {
    int64_t mid = (a + b) / 2;
    if (r->data[mid % r->capacity].t > t0) b = mid;
    else a = mid + 1;
  }
  int64_t i0 = std::max(lo, a - 1);

  int64_t out = 0;
  for (int64_t i = i0; i + 1 < n; ++i) {
    const Sample& s = r->data[i % r->capacity];
    const Sample& nx = r->data[(i + 1) % r->capacity];
    if (s.t >= t1) break;
    double ta = std::max(s.t, t0);
    double tb = std::min(nx.t, t1);
    double dt = tb - ta;
    if (dt <= 0) continue;
    if (out < cap) {
      std::memcpy(vals + 6 * out, s.v, 6 * sizeof(float));
      dts[out] = static_cast<float>(dt);
      mask[out] = 1;
    }
    ++out;
  }
  return out;
}

}  // extern "C"
