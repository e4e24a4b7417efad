// Native PointCloud2 decoder.
//
// The reference ingests LiDAR clouds with a per-point Python loop over
// sensor_msgs.point_cloud2.read_points (ref mapping.py:178-181) — its
// hottest host-side path (SURVEY.md section 3.2).  This is the native
// runtime replacement: strided binary PointCloud2 payloads decode
// directly into a dense column-major (4, N) float32 array, with NaN
// filtering (the skip_nans=True semantics), in one pass.
//
// The PyTorch/CUDA port's own copy of native/pointcloud.cpp (the JAX
// package's decoder), unchanged in what it computes.  Exposed as a tiny C
// ABI consumed through ctypes (runtime/native_io.py), which builds it with
// the host C++ compiler at first use into build/host_libs/; the numpy
// decoder there is its plain version.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

inline float load_field(const uint8_t* p, int32_t datatype) {
  // PointField datatypes (sensor_msgs/PointField)
  switch (datatype) {
    case 1: { int8_t v;   std::memcpy(&v, p, 1); return static_cast<float>(v); }
    case 2: { uint8_t v;  std::memcpy(&v, p, 1); return static_cast<float>(v); }
    case 3: { int16_t v;  std::memcpy(&v, p, 2); return static_cast<float>(v); }
    case 4: { uint16_t v; std::memcpy(&v, p, 2); return static_cast<float>(v); }
    case 5: { int32_t v;  std::memcpy(&v, p, 4); return static_cast<float>(v); }
    case 6: { uint32_t v; std::memcpy(&v, p, 4); return static_cast<float>(v); }
    case 7: { float v;    std::memcpy(&v, p, 4); return v; }
    case 8: { double v;   std::memcpy(&v, p, 8); return static_cast<float>(v); }
    default: return 0.0f;
  }
}

}  // namespace

extern "C" {

// Decode `num_points` points from a strided PointCloud2 payload.
//
// data:        raw message payload (num_points * point_step bytes)
// point_step:  stride between points in bytes
// offsets:     byte offset of each of the `num_fields` fields in a point
// datatypes:   PointField datatype code per field
// out:         (num_fields, num_points) float32, row-major per field
// skip_nans:   drop points with any non-finite field value
//
// Returns the number of points written (== num_points unless skip_nans),
// or -1 when num_fields exceeds the fixed per-point buffer (16 fields).
int64_t decode_pointcloud2(const uint8_t* data,
                           int64_t num_points,
                           int64_t point_step,
                           const int64_t* offsets,
                           const int32_t* datatypes,
                           int64_t num_fields,
                           float* out,
                           int32_t skip_nans) {
  if (num_fields < 0 || num_fields > 16) return -1;
  int64_t written = 0;
  for (int64_t i = 0; i < num_points; ++i) {
    const uint8_t* point = data + i * point_step;
    float vals[16];
    bool finite = true;
    for (int64_t f = 0; f < num_fields; ++f) {
      const float v = load_field(point + offsets[f], datatypes[f]);
      vals[f] = v;
      finite = finite && std::isfinite(v);
    }
    if (skip_nans && !finite) continue;
    for (int64_t f = 0; f < num_fields; ++f) {
      out[f * num_points + written] = vals[f];
    }
    ++written;
  }
  return written;
}

// Fused cloud prep: decode + pad/truncate to a static bucket with a
// validity mask — the exact host-side shape the jitted mapping step
// consumes (mapping/engine.py pad_points).
int64_t decode_and_bucket(const uint8_t* data,
                          int64_t num_points,
                          int64_t point_step,
                          const int64_t* offsets,
                          const int32_t* datatypes,
                          int64_t num_fields,
                          int64_t bucket,
                          float* out,      // (num_fields, bucket), pre-zeroed by caller or here
                          uint8_t* valid,  // (bucket,)
                          int32_t skip_nans) {
  if (num_fields < 0 || num_fields > 16) return -1;
  std::memset(out, 0, sizeof(float) * num_fields * bucket);
  std::memset(valid, 0, bucket);
  int64_t written = 0;
  for (int64_t i = 0; i < num_points && written < bucket; ++i) {
    const uint8_t* point = data + i * point_step;
    float vals[16];
    bool finite = true;
    for (int64_t f = 0; f < num_fields; ++f) {
      const float v = load_field(point + offsets[f], datatypes[f]);
      vals[f] = v;
      finite = finite && std::isfinite(v);
    }
    if (skip_nans && !finite) continue;
    for (int64_t f = 0; f < num_fields; ++f) {
      out[f * bucket + written] = vals[f];
    }
    valid[written] = 1;
    ++written;
  }
  return written;
}

}  // extern "C"
