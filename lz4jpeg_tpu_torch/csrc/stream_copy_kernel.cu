// Stream-copy kernel for Hopper (sm_90a): dst[i] = src[i] over n bytes of
// device memory, the card's kernel-side stream ceiling.
//
// Replaces profiles/probe_pallas_copy_ceiling.py::copy_kernel, the Pallas
// TPU probe (pallas_call at :56) that copies (rows, 2048) u8/i16/f32
// arrays block by block through VMEM to find what a bare kernel streams.
// profiles/dct_gates.py::lane_split (the fused-DCT gates' split) runs on
// it too.
//
// What bounds it.  2 bytes of device memory per byte copied (read once,
// written once) and no arithmetic: memory bandwidth.  At 512 MiB that is
// 1,073,741,824 bytes, about 0.32 ms at the data sheet's 3.35 TB/s.
//
// Design: the streaming template of csrc/stream_copy.cuh.  On Hopper there
// is no staging buffer to fill: 16-byte vectors go straight through
// registers, one CTA a 16 KiB chunk in index order, so the bytes in
// flight stay in one window of memory that moves through the array (a
// persistent grid-stride loop spread them over windows a grid stride
// apart).  The byte-wise head, tail and route where source and destination
// differ modulo 16 are the template's.

#include "stream_copy.cuh"

// Copy n bytes from src to dst (both device memory, not overlapping).
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
extern "C" int stream_copy_launch(const void* src, void* dst, long long n,
                                  void* stream) {
  return stream_copy::launch(src, dst, n, static_cast<cudaStream_t>(stream));
}

// The launch stream_copy_launch makes for these pointers and n > 0: plan[0]
// head bytes, plan[1] 16-byte vectors, plan[2] tail bytes, plan[3] CTAs.
extern "C" void stream_copy_plan(const void* src, const void* dst,
                                 long long n, long long* plan) {
  const stream_copy::Plan p = stream_copy::plan(src, dst, n);
  plan[0] = p.head;
  plan[1] = p.n_vec;
  plan[2] = p.tail;
  plan[3] = p.ctas;
}

extern "C" const char* stream_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
