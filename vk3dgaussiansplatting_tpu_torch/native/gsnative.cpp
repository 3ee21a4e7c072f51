// Native .ply loader of vk3dgaussiansplatting_tpu_torch: the port's own copy
// of vk3dgaussiansplatting_tpu/native/gsnative.cpp (plain C++, no JAX).
//
// C++ counterpart of the reference's hapPLY-based scene loading
// (Engine/ResourceManager.cpp:167-300): parses a binary_little_endian .ply
// gaussian cloud and extracts the 59 gaussian property columns into SoA
// float buffers, multi-threaded over record ranges.  Exposed to Python via a
// minimal C ABI (ctypes); numpy applies the activation transforms.
//
// Built at first use by native/runtime.py:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread gsnative.cpp -o <_build>/libgsnative_<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Property {
  std::string name;
  size_t size;    // bytes
  bool is_float;  // float32
  size_t offset;  // byte offset within a record
};

struct Loaded {
  int64_t count = 0;
  std::vector<float> xyz;        // [n*3]
  std::vector<float> scales;     // [n*3]
  std::vector<float> rots;       // [n*4]
  std::vector<float> opacities;  // [n]
  std::vector<float> f_dc;       // [n*3]
  std::vector<float> f_rest;     // [n*45]
};

Loaded g_loaded;

size_t type_size(const std::string& t, bool* is_float) {
  *is_float = false;
  if (t == "float" || t == "float32") {
    *is_float = true;
    return 4;
  }
  if (t == "double" || t == "float64") return 8;
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32") return 4;
  return 0;
}

// Parse the header; returns record size, element count and property map.
bool parse_header(std::ifstream& in, int64_t* count, size_t* record_size,
                  std::vector<Property>* props) {
  std::string line;
  if (!std::getline(in, line)) return false;
  if (line.size() && line.back() == '\r') line.pop_back();
  if (line != "ply") return false;
  bool binary_le = false;
  bool in_vertex = false;
  bool seen_vertex = false;
  size_t offset = 0;
  *count = 0;
  while (std::getline(in, line)) {
    if (line.size() && line.back() == '\r') line.pop_back();
    std::istringstream ss(line);
    std::string tok;
    ss >> tok;
    if (tok == "comment" || tok == "obj_info") continue;
    if (tok == "format") {
      std::string fmt;
      ss >> fmt;
      binary_le = (fmt == "binary_little_endian");
    } else if (tok == "element") {
      std::string name;
      int64_t n;
      ss >> name >> n;
      // Only the first (vertex) element is supported in the fast path.
      if (!seen_vertex) {
        seen_vertex = true;
        in_vertex = true;
        *count = n;
      } else {
        in_vertex = false;
        if (n > 0) return false;  // trailing elements unsupported
      }
    } else if (tok == "property") {
      std::string type, name;
      ss >> type;
      if (type == "list") return false;
      ss >> name;
      if (!in_vertex) continue;
      bool is_f;
      size_t sz = type_size(type, &is_f);
      if (sz == 0) return false;
      props->push_back({name, sz, is_f, offset});
      offset += sz;
    } else if (tok == "end_header") {
      *record_size = offset;
      return binary_le && seen_vertex;
    }
  }
  return false;
}

const Property* find_prop(const std::vector<Property>& props,
                          const std::string& name) {
  for (const auto& p : props)
    if (p.name == name) return &p;
  return nullptr;
}

inline float read_f32(const uint8_t* rec, const Property& p) {
  float v;
  std::memcpy(&v, rec + p.offset, 4);
  return v;
}

}  // namespace

extern "C" {

// Parse `path`; returns 0 on success and sets *count.  Non-zero -> caller
// should fall back to the Python parser (ascii files, exotic layouts).
int gs_load_ply(const char* path, int64_t* count) {
  g_loaded = Loaded{};
  std::ifstream in(path, std::ios::binary);
  if (!in) return 1;
  int64_t n = 0;
  size_t record_size = 0;
  std::vector<Property> props;
  if (!parse_header(in, &n, &record_size, &props)) return 2;

  // Required property set (ResourceManager.cpp:176-222).
  const Property* px = find_prop(props, "x");
  const Property* py = find_prop(props, "y");
  const Property* pz = find_prop(props, "z");
  const Property* pop = find_prop(props, "opacity");
  const Property* psc[3];
  const Property* prt[4];
  const Property* pdc[3];
  for (int i = 0; i < 3; ++i) {
    psc[i] = find_prop(props, "scale_" + std::to_string(i));
    pdc[i] = find_prop(props, "f_dc_" + std::to_string(i));
  }
  for (int i = 0; i < 4; ++i) prt[i] = find_prop(props, "rot_" + std::to_string(i));
  if (!px || !py || !pz || !pop) return 3;
  for (int i = 0; i < 3; ++i)
    if (!psc[i] || !pdc[i]) return 3;
  for (int i = 0; i < 4; ++i)
    if (!prt[i]) return 3;
  const Property* prest[45];
  bool have_rest = true;
  for (int i = 0; i < 45; ++i) {
    prest[i] = find_prop(props, "f_rest_" + std::to_string(i));
    if (!prest[i]) have_rest = false;
  }
  // All relevant columns must be float32 for the memcpy fast path.
  for (const auto& p : props)
    if (!p.is_float) return 4;

  std::streampos body = in.tellg();
  in.seekg(0, std::ios::end);
  std::streampos end = in.tellg();
  if (static_cast<int64_t>(end - body) < n * (int64_t)record_size) return 5;
  std::vector<uint8_t> buf(n * record_size);
  in.seekg(body);
  in.read(reinterpret_cast<char*>(buf.data()), buf.size());
  if (!in) return 6;

  g_loaded.count = n;
  g_loaded.xyz.resize(n * 3);
  g_loaded.scales.resize(n * 3);
  g_loaded.rots.resize(n * 4);
  g_loaded.opacities.resize(n);
  g_loaded.f_dc.resize(n * 3);
  g_loaded.f_rest.assign(n * 45, 0.0f);

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? hw : 2;
  if ((size_t)n < 10000) nthreads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = buf.data() + i * record_size;
      g_loaded.xyz[i * 3 + 0] = read_f32(rec, *px);
      g_loaded.xyz[i * 3 + 1] = read_f32(rec, *py);
      g_loaded.xyz[i * 3 + 2] = read_f32(rec, *pz);
      for (int c = 0; c < 3; ++c) {
        g_loaded.scales[i * 3 + c] = read_f32(rec, *psc[c]);
        g_loaded.f_dc[i * 3 + c] = read_f32(rec, *pdc[c]);
      }
      for (int c = 0; c < 4; ++c)
        g_loaded.rots[i * 4 + c] = read_f32(rec, *prt[c]);
      g_loaded.opacities[i] = read_f32(rec, *pop);
      if (have_rest) {
        for (int c = 0; c < 45; ++c)
          g_loaded.f_rest[i * 45 + c] = read_f32(rec, *prest[c]);
      }
    }
  };
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (size_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back(work, lo, hi);
  }
  for (auto& w : workers) w.join();

  *count = n;
  return 0;
}

int gs_fetch_columns(void* xyz, void* scales, void* rots, void* opacities,
                     void* f_dc, void* f_rest) {
  if (g_loaded.count == 0) return 1;
  int64_t n = g_loaded.count;
  std::memcpy(xyz, g_loaded.xyz.data(), n * 3 * sizeof(float));
  std::memcpy(scales, g_loaded.scales.data(), n * 3 * sizeof(float));
  std::memcpy(rots, g_loaded.rots.data(), n * 4 * sizeof(float));
  std::memcpy(opacities, g_loaded.opacities.data(), n * sizeof(float));
  std::memcpy(f_dc, g_loaded.f_dc.data(), n * 3 * sizeof(float));
  std::memcpy(f_rest, g_loaded.f_rest.data(), n * 45 * sizeof(float));
  return 0;
}

void gs_free() { g_loaded = Loaded{}; }

}  // extern "C"
