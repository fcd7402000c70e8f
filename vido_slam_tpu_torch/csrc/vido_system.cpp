// C facade over the PyTorch port: the reference's libvido_slam.so entry
// points (vido_slam/include/System.h:72-118, src/System.cc:23-240) with the
// C ABI of the JAX package's native/vido_system.h. The shared library
// embeds CPython, imports vido_slam_tpu_torch.native_system (which owns a
// vido_slam_tpu_torch.system.System) and forwards every call to it with
// the caller's buffers as addresses; the Python half copies them into
// numpy arrays and writes the pose and object rows back. It works as a
// standalone embed (a C++ host process, csrc/run_vido_native.cpp) and
// loaded into a Python process (ctypes.CDLL): the GIL is taken per call
// either way. A failed call prints the Python error and returns -1.
//
// Built at first use by vido_slam_tpu_torch/native_system.py through
// utils/host_build.py. It links no libpython (see host_build.python_flags).

#include <Python.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <string>

#include "vido_system.h"

#ifndef VIDO_PYTHON_EXECUTABLE
#define VIDO_PYTHON_EXECUTABLE ""
#endif

namespace {

// Starts the interpreter unless the process has one. The executable baked
// in at build time lets it find the virtual environment that built it.
bool ensure_interpreter() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  PyStatus st = PyStatus_Ok();
  if (VIDO_PYTHON_EXECUTABLE[0])
    st = PyConfig_SetBytesString(&config, &config.executable,
                                 VIDO_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    std::fprintf(stderr, "vido_system: Python did not start: %s\n",
                 st.err_msg ? st.err_msg : "(no message)");
    return false;
  }
  // release the GIL taken by the initialisation, so that every call takes
  // it the same way
  PyEval_SaveThread();
  return true;
}

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

struct SystemImpl {
  PyObject* mod = nullptr;   // vido_slam_tpu_torch.native_system
  PyObject* self = nullptr;  // its System
};

// The checkout's root: this library lives in <root>/vido_slam_tpu_torch/
// build/.
std::string repo_root() {
  Dl_info info;
  if (!dladdr(reinterpret_cast<void*>(&vido_system_create), &info) ||
      !info.dli_fname)
    return "";
  std::string path(info.dli_fname);
  for (int up = 0; up < 3; ++up) {
    auto cut = path.find_last_of('/');
    path = cut == std::string::npos ? "." : path.substr(0, cut);
  }
  return path;
}

unsigned long long addr(const void* p) {
  return static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(p));
}

// native_system.<name>(*args) as an int; args is a new reference (or null
// after a failed Py_BuildValue). -1 after printing the error.
int call(SystemImpl* impl, const char* name, PyObject* args) {
  if (!args) { PyErr_Print(); return -1; }
  PyObject* fn = PyObject_GetAttrString(impl->mod, name);
  PyObject* r = fn ? PyObject_CallObject(fn, args) : nullptr;
  Py_XDECREF(fn);
  Py_DECREF(args);
  if (!r) { PyErr_Print(); return -1; }
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  if (v == -1 && PyErr_Occurred()) { PyErr_Print(); return -1; }
  return static_cast<int>(v);
}

}  // namespace

extern "C" {

void* vido_system_create() {
  if (!ensure_interpreter()) return nullptr;
  Gil gil;
  // a standalone embed must see the checkout; loaded into a Python
  // process that imported the package already, this changes nothing
  std::string root = repo_root();
  PyObject* path = PySys_GetObject("path");  // borrowed
  PyObject* s = PyUnicode_FromString(root.c_str());
  if (path && s && !root.empty() && !PySequence_Contains(path, s))
    PyList_Insert(path, 0, s);
  Py_XDECREF(s);
  PyObject* mod = PyImport_ImportModule("vido_slam_tpu_torch.native_system");
  if (!mod) { PyErr_Print(); return nullptr; }
  PyObject* self = PyObject_CallMethod(mod, "create", nullptr);
  if (!self) { PyErr_Print(); Py_DECREF(mod); return nullptr; }
  return new SystemImpl{mod, self};
}

// sensor: 0 = MONOCULAR, 1 = STEREO, 2 = RGBD, 3 = IMU_RGBD
int vido_system_init(void* sys, const char* settings_file, int sensor) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "init", Py_BuildValue("(Osi)", impl->self, settings_file,
                                          sensor));
}

int vido_system_init_ex(void* sys, const char* settings_file, int sensor,
                        const char* json_kwargs) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "init", Py_BuildValue("(Osis)", impl->self,
                                          settings_file, sensor,
                                          json_kwargs));
}

// depth (H,W) f32 raw network values, flow (H,W,2) f32, mask (H,W) i32,
// gray (H,W) f32 or NULL, tcw_gt 16 floats row-major or NULL.
// pose_out: 16 floats (row-major Tcw). Returns 0 on success.
int vido_system_track(void* sys, const float* gray, const float* depth,
                      const float* flow, const int* mask,
                      const float* tcw_gt, double timestamp,
                      int H, int W, float* pose_out) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "track", Py_BuildValue(
      "(OKKKKKdiiK)", impl->self, addr(gray), addr(depth), addr(flow),
      addr(mask), addr(tcw_gt), timestamp, H, W, addr(pose_out)));
}

int vido_system_track_imu(void* sys, const float* gray, const float* depth,
                          const float* flow, const int* mask,
                          const float* tcw_gt, double timestamp,
                          const double* imu, int n_imu,
                          int H, int W, float* pose_out) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "track_imu", Py_BuildValue(
      "(OKKKKKdKiiiK)", impl->self, addr(gray), addr(depth), addr(flow),
      addr(mask), addr(tcw_gt), timestamp, addr(imu), n_imu, H, W,
      addr(pose_out)));
}

int vido_system_get_objects(void* sys, int frame_index, double* out,
                            int max_n) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "get_objects", Py_BuildValue(
      "(OiKi)", impl->self, frame_index, addr(out), max_n));
}

int vido_system_save(void* sys, const char* path) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (!impl) return -1;
  Gil gil;
  return call(impl, "save", Py_BuildValue("(Os)", impl->self, path));
}

void vido_system_destroy(void* sys) {
  auto* impl = static_cast<SystemImpl*>(sys);
  if (impl) {
    Gil gil;
    Py_XDECREF(impl->self);
    Py_XDECREF(impl->mod);
    delete impl;
  }
}

}  // extern "C"
