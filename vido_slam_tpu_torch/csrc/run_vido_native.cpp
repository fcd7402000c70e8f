// Standalone C++ host of the PyTorch port — the reference's `run_vido`
// binary shape (demo/run_vido_slam.cc): a pure C++ process that owns
// VIDO_SLAM::System, embedding CPython and the port through the C facade
// (csrc/vido_system.cpp).
//
//   run_vido_native <config.yaml> [n_frames] [json_kwargs]
//
// Feeds synthetic 160x256 frames (hash-textured depth, zero flow, empty
// mask) and prints each returned pose's translation, then "ok". The JSON
// object, if given, goes to System.Init as keyword arguments, e.g.
// '{"device": "cpu"}'; without it the system runs on the card.
//
// Built at first use by vido_slam_tpu_torch/native_system.py::runner.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include "vido_system.h"

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <config.yaml> [n_frames] [json_kwargs]\n",
                 argv[0]);
    return 2;
  }
  const int n_frames = argc > 2 ? std::atoi(argv[2]) : 3;
  const int H = 160, W = 256;

  vido_slam::System slam;
  if (argc > 3)
    slam.Init(argv[1], vido_slam::RGBD, argv[3]);
  else
    slam.Init(argv[1], vido_slam::RGBD);

  std::vector<float> depth(H * W), flow(H * W * 2, 0.0f);
  std::vector<int> mask(H * W, 0);
  std::vector<float> pose(16);
  for (int i = 0; i < H * W; ++i) {
    // raw depth (OMD convention: metric * DepthMapFactor=100)
    depth[i] = 100.0f * (8.0f + 4.0f * ((i * 2654435761u >> 16) & 0xff) / 255.0f);
  }
  for (int t = 0; t < n_frames; ++t) {
    slam.TrackRGBD(nullptr, depth.data(), flow.data(), mask.data(), nullptr,
                   t / 10.0, H, W, pose.data());
    std::printf("frame %d: t = [%.4f %.4f %.4f]\n", t, pose[3], pose[7],
                pose[11]);
  }
  std::printf("ok\n");
  return 0;
}
