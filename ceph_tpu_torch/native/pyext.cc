// CPython extension bindings for the native EC kernels.
//
// The ctypes path costs ~8-10us per call (pointer casts + foreign
// call setup) — more than the whole AVX2 encode of a 4KiB-chunk
// stripe.  This module is the reference's "plugin .so" analog done
// properly for a Python host: a C-API entry point whose per-call
// overhead is a few hundred ns, so small-op EC throughput is bounded
// by the kernel, not the binding.  Buffers come in via the buffer
// protocol (numpy arrays pass through zero-copy).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstddef>

extern "C" {
void ceph_tpu_gf_encode_best(const uint8_t*, size_t, size_t,
                             const uint8_t*, uint8_t*, size_t);
void ceph_tpu_gf_encode_batch(const uint8_t*, size_t, size_t,
                              const uint8_t*, uint8_t*, size_t, size_t);
void ceph_tpu_bitmatrix_encode(const uint8_t*, size_t, size_t,
                               const uint8_t*, uint8_t*, size_t, size_t,
                               size_t);
uint32_t ceph_tpu_crc32c(uint32_t, const uint8_t*, size_t);
}

namespace {

struct Buf {
  Py_buffer view{};
  bool ok = false;
  Buf(PyObject* obj, int flags) {
    ok = PyObject_GetBuffer(obj, &view, flags) == 0;
  }
  ~Buf() {
    if (ok) PyBuffer_Release(&view);
  }
  const uint8_t* data() const {
    return static_cast<const uint8_t*>(view.buf);
  }
  uint8_t* wdata() const { return static_cast<uint8_t*>(view.buf); }
  size_t len() const { return static_cast<size_t>(view.len); }
};

// gf_encode(matrix, rows, k, data, parity, length)
PyObject* py_gf_encode(PyObject*, PyObject* const* args,
                       Py_ssize_t nargs) {
  if (nargs != 6) {
    PyErr_SetString(PyExc_TypeError, "gf_encode takes 6 args");
    return nullptr;
  }
  const size_t rows = PyLong_AsSize_t(args[1]);
  const size_t k = PyLong_AsSize_t(args[2]);
  const size_t len = PyLong_AsSize_t(args[5]);
  if (PyErr_Occurred()) return nullptr;
  Buf matrix(args[0], PyBUF_C_CONTIGUOUS);
  Buf data(args[3], PyBUF_C_CONTIGUOUS);
  Buf parity(args[4], PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS);
  if (!matrix.ok || !data.ok || !parity.ok) return nullptr;
  if (matrix.len() < rows * k || data.len() < k * len ||
      parity.len() < rows * len) {
    PyErr_SetString(PyExc_ValueError, "gf_encode: buffer too small");
    return nullptr;
  }
  Py_BEGIN_ALLOW_THREADS
  ceph_tpu_gf_encode_best(matrix.data(), rows, k, data.data(),
                          parity.wdata(), len);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

// gf_encode_batch(matrix, rows, k, data, parity, length, nstripes)
PyObject* py_gf_encode_batch(PyObject*, PyObject* const* args,
                             Py_ssize_t nargs) {
  if (nargs != 7) {
    PyErr_SetString(PyExc_TypeError, "gf_encode_batch takes 7 args");
    return nullptr;
  }
  const size_t rows = PyLong_AsSize_t(args[1]);
  const size_t k = PyLong_AsSize_t(args[2]);
  const size_t len = PyLong_AsSize_t(args[5]);
  const size_t nstripes = PyLong_AsSize_t(args[6]);
  if (PyErr_Occurred()) return nullptr;
  Buf matrix(args[0], PyBUF_C_CONTIGUOUS);
  Buf data(args[3], PyBUF_C_CONTIGUOUS);
  Buf parity(args[4], PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS);
  if (!matrix.ok || !data.ok || !parity.ok) return nullptr;
  if (matrix.len() < rows * k || data.len() < nstripes * k * len ||
      parity.len() < nstripes * rows * len) {
    PyErr_SetString(PyExc_ValueError,
                    "gf_encode_batch: buffer too small");
    return nullptr;
  }
  Py_BEGIN_ALLOW_THREADS
  ceph_tpu_gf_encode_batch(matrix.data(), rows, k, data.data(),
                           parity.wdata(), len, nstripes);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

// bitmatrix_encode(bits, mw, kw, data, parity, L, w, packetsize)
PyObject* py_bitmatrix_encode(PyObject*, PyObject* const* args,
                              Py_ssize_t nargs) {
  if (nargs != 8) {
    PyErr_SetString(PyExc_TypeError, "bitmatrix_encode takes 8 args");
    return nullptr;
  }
  const size_t mw = PyLong_AsSize_t(args[1]);
  const size_t kw = PyLong_AsSize_t(args[2]);
  const size_t L = PyLong_AsSize_t(args[5]);
  const size_t w = PyLong_AsSize_t(args[6]);
  const size_t ps = PyLong_AsSize_t(args[7]);
  if (PyErr_Occurred()) return nullptr;
  Buf bits(args[0], PyBUF_C_CONTIGUOUS);
  Buf data(args[3], PyBUF_C_CONTIGUOUS);
  Buf parity(args[4], PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS);
  if (!bits.ok || !data.ok || !parity.ok) return nullptr;
  if (w == 0 || ps == 0 || L % (w * ps) != 0 || kw % w != 0 ||
      mw % w != 0) {
    PyErr_SetString(PyExc_ValueError, "bitmatrix_encode: bad geometry");
    return nullptr;
  }
  if (bits.len() < mw * kw || data.len() < (kw / w) * L ||
      parity.len() < (mw / w) * L) {
    PyErr_SetString(PyExc_ValueError,
                    "bitmatrix_encode: buffer too small");
    return nullptr;
  }
  Py_BEGIN_ALLOW_THREADS
  ceph_tpu_bitmatrix_encode(bits.data(), mw, kw, data.data(),
                            parity.wdata(), L, w, ps);
  Py_END_ALLOW_THREADS
  Py_RETURN_NONE;
}

// crc32c(seed, buf) -> int
PyObject* py_crc32c(PyObject*, PyObject* const* args,
                    Py_ssize_t nargs) {
  if (nargs != 2) {
    PyErr_SetString(PyExc_TypeError, "crc32c takes 2 args");
    return nullptr;
  }
  const uint32_t seed =
      static_cast<uint32_t>(PyLong_AsUnsignedLongMask(args[0]));
  Buf buf(args[1], PyBUF_C_CONTIGUOUS);
  if (!buf.ok) return nullptr;
  uint32_t out;
  Py_BEGIN_ALLOW_THREADS
  out = ceph_tpu_crc32c(seed, buf.data(), buf.len());
  Py_END_ALLOW_THREADS
  return PyLong_FromUnsignedLong(out);
}

PyMethodDef kMethods[] = {
    {"gf_encode", reinterpret_cast<PyCFunction>(py_gf_encode),
     METH_FASTCALL, "parity = matrix x data over GF(2^8)"},
    {"gf_encode_batch",
     reinterpret_cast<PyCFunction>(py_gf_encode_batch), METH_FASTCALL,
     "batched stripes: parity[S] = matrix x data[S]"},
    {"bitmatrix_encode",
     reinterpret_cast<PyCFunction>(py_bitmatrix_encode), METH_FASTCALL,
     "packetized GF(2) bitmatrix encode"},
    {"crc32c", reinterpret_cast<PyCFunction>(py_crc32c), METH_FASTCALL,
     "CRC32C (Castagnoli)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_ceph_tpu_native",
                       "native EC kernel bindings", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__ceph_tpu_native(void) {
  return PyModule_Create(&kModule);
}
