// C facade over the PyTorch port — the reference's VIDO_SLAM::System
// surface (vido_slam/include/System.h:72-118) for C++ host applications,
// the same C ABI as the JAX package's native/vido_system.h, plus
// vido_system_init_ex. Raw row-major buffers replace cv::Mat (OpenCV is
// not a dependency of the port).
#pragma once

#include <stdexcept>
#include <string>

extern "C" {
void* vido_system_create();
// Init on the card (cuda); settings_file is the YAML configuration.
int vido_system_init(void* sys, const char* settings_file, int sensor);
// Init with extra System.Init keyword arguments as a JSON object string,
// e.g. {"device": "cpu", "n_bg": 600, "n_obj": 1500, "max_objects": 4}.
int vido_system_init_ex(void* sys, const char* settings_file, int sensor,
                        const char* json_kwargs);
int vido_system_track(void* sys, const float* gray, const float* depth,
                      const float* flow, const int* mask,
                      const float* tcw_gt, double timestamp,
                      int H, int W, float* pose_out);
// VIO overload (System.h:98-100): imu = n_imu rows (ax,ay,az,wx,wy,wz,t) f64
int vido_system_track_imu(void* sys, const float* gray, const float* depth,
                          const float* flow, const int* mask,
                          const float* tcw_gt, double timestamp,
                          const double* imu, int n_imu,
                          int H, int W, float* pose_out);
// Per-frame scene objects (OutPut.h:35-72): rows of 10 doubles
// [tracking_id, label_index, pos_xyz, vel_xyz, yaw, speed_kmh];
// returns the total object count (may exceed max_n), -1 on error.
int vido_system_get_objects(void* sys, int frame_index, double* out,
                            int max_n);
int vido_system_save(void* sys, const char* path);
void vido_system_destroy(void* sys);
}

namespace vido_slam {

enum eSensor { MONOCULAR = 0, STEREO = 1, RGBD = 2, IMU_RGBD = 3 };

class System {
 public:
  System() : impl_(vido_system_create()) {
    if (!impl_) throw std::runtime_error("vido_system_create failed");
  }
  ~System() { vido_system_destroy(impl_); }
  System(const System&) = delete;
  System& operator=(const System&) = delete;

  void Init(const std::string& settings_file, eSensor sensor) {
    if (vido_system_init(impl_, settings_file.c_str(), sensor) != 0)
      throw std::runtime_error("System::Init failed");
  }

  // Init with System.Init keyword arguments as a JSON object string.
  void Init(const std::string& settings_file, eSensor sensor,
            const std::string& json_kwargs) {
    if (vido_system_init_ex(impl_, settings_file.c_str(), sensor,
                            json_kwargs.c_str()) != 0)
      throw std::runtime_error("System::Init failed");
  }

  // Returns the 4x4 row-major camera pose Tcw in pose_out[16].
  void TrackRGBD(const float* gray, const float* depth_raw, const float* flow,
                 const int* mask_sem, const float* tcw_gt, double timestamp,
                 int height, int width, float* pose_out) {
    if (vido_system_track(impl_, gray, depth_raw, flow, mask_sem, tcw_gt,
                          timestamp, height, width, pose_out) != 0)
      throw std::runtime_error("System::TrackRGBD failed");
  }

  // VIO overload: imu = n_imu rows of (ax, ay, az, wx, wy, wz, t).
  void TrackRGBD(const float* gray, const float* depth_raw, const float* flow,
                 const int* mask_sem, const float* tcw_gt, double timestamp,
                 const double* imu, int n_imu,
                 int height, int width, float* pose_out) {
    if (vido_system_track_imu(impl_, gray, depth_raw, flow, mask_sem, tcw_gt,
                              timestamp, imu, n_imu, height, width,
                              pose_out) != 0)
      throw std::runtime_error("System::TrackRGBD (VIO) failed");
  }

  // Latest frame's scene objects; returns the object count (rows of 10
  // doubles: tracking_id, label_index, pos xyz, vel xyz, yaw, speed_kmh).
  int GetObjects(double* out, int max_n, int frame_index = -1) {
    return vido_system_get_objects(impl_, frame_index, out, max_n);
  }

  void SaveResultsIJRR2020(const std::string& path) {
    if (vido_system_save(impl_, path.c_str()) != 0)
      throw std::runtime_error("System::SaveResultsIJRR2020 failed");
  }

 private:
  void* impl_;
};

}  // namespace vido_slam
