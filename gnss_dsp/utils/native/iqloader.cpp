// Native host-side sample ingest for gnss_dsp.
//
// The reference's only native tier is Numba; its I/O path
// (gnsstools/io.py:3-12) round-trips through numpy fancy indexing.  At
// the 69.984 MHz 3-band capture rate the host must sustain ~140 MB/s of
// int8 I/Q -> planar f32 conversion while the device computes, so the
// deinterleave lives here as a tight auto-vectorizable loop, exposed via
// ctypes (gnss_dsp/utils/native.py) with a numpy fallback.

#include <cstddef>
#include <cstdint>
#include <cstdio>

extern "C" {

// interleaved int8 I/Q -> planar float32 (split-complex device layout)
void iq_deinterleave_f32(const int8_t* in, float* re, float* im,
                         size_t n_samples) {
  for (size_t i = 0; i < n_samples; ++i) {
    re[i] = static_cast<float>(in[2 * i]);
    im[i] = static_cast<float>(in[2 * i + 1]);
  }
}

// interleaved int8 I/Q -> interleaved float32 pairs (complex64 layout)
void iq_deinterleave_c64(const int8_t* in, float* out, size_t n_samples) {
  for (size_t i = 0; i < 2 * n_samples; ++i) {
    out[i] = static_cast<float>(in[i]);
  }
}

// blocking full read of n bytes from a C FILE*; returns bytes read
// (short only at EOF) — the chunked reader's refill primitive
size_t iq_fread_full(FILE* fp, int8_t* buf, size_t n_bytes) {
  size_t got = 0;
  while (got < n_bytes) {
    size_t r = fread(buf + got, 1, n_bytes - got, fp);
    if (r == 0) break;
    got += r;
  }
  return got;
}

// fused read + deinterleave from a file descriptor-backed FILE*
// opened by the caller; returns samples produced
size_t iq_read_deinterleave(FILE* fp, int8_t* scratch, float* re, float* im,
                            size_t n_samples) {
  size_t got = iq_fread_full(fp, scratch, 2 * n_samples);
  size_t ns = got / 2;
  iq_deinterleave_f32(scratch, re, im, ns);
  return ns;
}

}  // extern "C"
