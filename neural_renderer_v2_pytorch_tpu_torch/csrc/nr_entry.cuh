// The packed C entry of every kernel wrapper.
//
// A wrapper in ops/resolve_cuda.py calls nr_<name>(args, stream): `args` is
// a block of int64 slots that it fills in one pass: the card, then one slot
// per argument of the typed host function <name>(stream, ...) in the same
// order.  A pointer or an int is its value; a float is the bit pattern of a
// double, rounded to float here as a float argument of a C call would be.
// So ctypes converts two arguments per launch, not the 6 to 19 of the typed
// signature, and the typed functions and their kernels stay as they are.
// The entry launches on the card in slot 0 (`stream` is that card's), and
// switches to it and back only when it is not the current card.
//
//   static int face_setup(void* stream, const float* fvp, ...) { ... }
//   NR_PACKED_ENTRY(face_setup)   // extern "C" int nr_face_setup(const long long*, void*)

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <utility>

namespace nr_entry {

template <class T>
inline T slot(long long v) {
  if constexpr (std::is_pointer_v<T>) {
    return reinterpret_cast<T>(static_cast<std::intptr_t>(v));
  } else if constexpr (std::is_same_v<T, float>) {
    double d;
    std::memcpy(&d, &v, sizeof d);
    return static_cast<float>(d);
  } else {
    return static_cast<T>(v);
  }
}

template <class... A, std::size_t... I>
int call(int (*fn)(void*, A...), const long long* args, void* stream,
         std::index_sequence<I...>) {
  return fn(stream, slot<A>(args[I])...);
}

template <class... A>
int unpack(int (*fn)(void*, A...), const long long* args, void* stream) {
  const int device = static_cast<int>(args[0]);
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int status = call(fn, args + 1, stream, std::index_sequence_for<A...>{});
  if (current != device) {
    err = cudaSetDevice(current);
    if (status == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return status;
}

}  // namespace nr_entry

#define NR_PACKED_ENTRY(name)                                          \
  extern "C" int nr_##name(const long long* args, void* stream) {      \
    return nr_entry::unpack(name, args, stream);                       \
  }
