// crc32c (Castagnoli, reflected polynomial 0x82F63B78), slice-by-8: the
// record checksums of the TFRecord container
// (calciumgan_tpu_torch/data/tfrecord.py). A copy of `cg_crc32c` from the
// JAX package's calciumgan_tpu/native/calciumgan_native.cc, built at first
// use by kernels/build.py:load_host with the same flags as the OASIS redo.

#include <cstdint>
#include <cstring>

extern "C" {

// Table construction runs inside a C++11 magic static (thread-safe,
// guaranteed once): ctypes releases the GIL during calls.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; ++i) {
      uint32_t c = static_cast<uint32_t>(i);
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s) {
      for (int i = 0; i < 256; ++i) {
        uint32_t c = t[s - 1][i];
        t[s][i] = t[0][c & 0xFF] ^ (c >> 8);
      }
    }
  }
};

static const uint32_t (&crc_tables_ref())[8][256] {
  static const CrcTables tables;  // magic static: thread-safe init
  return tables.t;
}

uint32_t cg_crc32c(const uint8_t* data, uint64_t n) {
  const uint32_t (&crc_tables)[8][256] = crc_tables_ref();
  uint32_t crc = 0xFFFFFFFFu;
  uint64_t i = 0;
  while (n - i >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= crc;
    crc = crc_tables[7][lo & 0xFF] ^ crc_tables[6][(lo >> 8) & 0xFF] ^
          crc_tables[5][(lo >> 16) & 0xFF] ^ crc_tables[4][(lo >> 24) & 0xFF] ^
          crc_tables[3][hi & 0xFF] ^ crc_tables[2][(hi >> 8) & 0xFF] ^
          crc_tables[1][(hi >> 16) & 0xFF] ^ crc_tables[0][(hi >> 24) & 0xFF];
    i += 8;
  }
  for (; i < n; ++i) crc = (crc >> 8) ^ crc_tables[0][(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
