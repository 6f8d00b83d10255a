// KITTI AP evaluator (native, host-side).
//
// Reimplements the official KITTI devkit `evaluate_object` protocol — the
// reference ships it only as precompiled binaries
// (tools/kitti_object/kitti_evaluation_lib/evaluate_object_0.{5,7}, invoked
// from kitti_eval.py:48-52). Same stats_<cls>_detection{,_ground,_3d}.txt /
// stats_<cls>_orientation.txt output format (3 difficulty rows x 41
// precision samples).
//
// Usage: kitti_ap <gt_dir> <pred_txt_dir> <out_dir> <class> <iou_thresh>
//
// Build: g++ -O2 -std=c++17 -o build/kitti_ap kitti_ap.cpp

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fstream>
#include <sstream>
#include <string>
#include <sys/stat.h>
#include <vector>

static const int N_SAMPLE_PTS = 41;
static const double MIN_HEIGHT[3] = {40.0, 25.0, 25.0};
static const int MAX_OCCLUSION[3] = {0, 1, 2};
static const double MAX_TRUNCATION[3] = {0.15, 0.30, 0.50};

struct Obj {
  std::string cls;
  double trunc{}, occ{}, alpha{};
  double x1{}, y1{}, x2{}, y2{};
  double h{}, w{}, l{};
  double x{}, y{}, z{}, ry{};
  double score{-1};
};

enum Metric { IMAGE = 0, GROUND = 1, BOX3D = 2 };

static std::vector<Obj> parseFile(const std::string &path) {
  std::vector<Obj> out;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    Obj o;
    if (!(ss >> o.cls >> o.trunc >> o.occ >> o.alpha >> o.x1 >> o.y1 >> o.x2 >>
          o.y2 >> o.h >> o.w >> o.l >> o.x >> o.y >> o.z >> o.ry))
      continue;
    ss >> o.score;  // optional
    out.push_back(o);
  }
  return out;
}

static double iou2d(const Obj &a, const Obj &b) {
  double ix = std::min(a.x2, b.x2) - std::max(a.x1, b.x1);
  double iy = std::min(a.y2, b.y2) - std::max(a.y1, b.y1);
  if (ix <= 0 || iy <= 0) return 0.0;
  double inter = ix * iy;
  double u = (a.x2 - a.x1) * (a.y2 - a.y1) + (b.x2 - b.x1) * (b.y2 - b.y1) - inter;
  return inter / std::max(u, 1e-12);
}

struct Pt {
  double x, y;
};

static void rectPoly(const Obj &o, Pt p[4]) {
  double c = std::cos(o.ry), s = std::sin(o.ry);
  double dx[4] = {o.l / 2, o.l / 2, -o.l / 2, -o.l / 2};
  double dz[4] = {o.w / 2, -o.w / 2, -o.w / 2, o.w / 2};
  for (int i = 0; i < 4; i++) {
    p[i].x = o.x + c * dx[i] + s * dz[i];
    p[i].y = o.z - s * dx[i] + c * dz[i];
  }
}

// Sutherland–Hodgman clip of convex polygons.
static double polyClipArea(const Pt pa[4], const Pt pbIn[4]) {
  Pt pb[4];
  // ensure CCW clip polygon
  double ar2 = 0;
  for (int i = 0; i < 4; i++) {
    int j = (i + 1) % 4;
    ar2 += pbIn[i].x * pbIn[j].y - pbIn[j].x * pbIn[i].y;
  }
  for (int i = 0; i < 4; i++) pb[i] = ar2 < 0 ? pbIn[3 - i] : pbIn[i];

  std::vector<Pt> poly(pa, pa + 4), next;
  for (int e = 0; e < 4 && !poly.empty(); e++) {
    const Pt &A = pb[e], &B = pb[(e + 1) % 4];
    next.clear();
    size_t n = poly.size();
    for (size_t i = 0; i < n; i++) {
      const Pt &cur = poly[i];
      const Pt &prev = poly[(i + n - 1) % n];
      double sc = (B.x - A.x) * (cur.y - A.y) - (B.y - A.y) * (cur.x - A.x);
      double sp = (B.x - A.x) * (prev.y - A.y) - (B.y - A.y) * (prev.x - A.x);
      auto isect = [&]() {
        double d1x = cur.x - prev.x, d1y = cur.y - prev.y;
        double d2x = B.x - A.x, d2y = B.y - A.y;
        double den = d1x * d2y - d1y * d2x;
        double t = ((A.x - prev.x) * d2y - (A.y - prev.y) * d2x) / den;
        return Pt{prev.x + t * d1x, prev.y + t * d1y};
      };
      if (sc >= -1e-12) {
        if (sp < -1e-12) next.push_back(isect());
        next.push_back(cur);
      } else if (sp >= -1e-12) {
        next.push_back(isect());
      }
    }
    poly = next;
  }
  if (poly.size() < 3) return 0.0;
  double area = 0;
  for (size_t i = 0; i < poly.size(); i++) {
    size_t j = (i + 1) % poly.size();
    area += poly[i].x * poly[j].y - poly[j].x * poly[i].y;
  }
  return std::fabs(area) / 2.0;
}

static double iouBev(const Obj &a, const Obj &b) {
  Pt pa[4], pb[4];
  rectPoly(a, pa);
  rectPoly(b, pb);
  double inter = polyClipArea(pa, pb);
  return inter / std::max(a.l * a.w + b.l * b.w - inter, 1e-12);
}

static double iou3dF(const Obj &a, const Obj &b) {
  Pt pa[4], pb[4];
  rectPoly(a, pa);
  rectPoly(b, pb);
  double interBev = polyClipArea(pa, pb);
  double ymin = std::max(a.y - a.h, b.y - b.h);
  double ymax = std::min(a.y, b.y);
  double inter = interBev * std::max(ymax - ymin, 0.0);
  return inter / std::max(a.h * a.w * a.l + b.h * b.w * b.l - inter, 1e-12);
}

static double overlap(Metric m, const Obj &a, const Obj &b) {
  switch (m) {
    case IMAGE: return iou2d(a, b);
    case GROUND: return iouBev(a, b);
    default: return iou3dF(a, b);
  }
}

struct Cleaned {
  std::vector<int> iGt, iDet;
  std::vector<int> dontcare;  // gt indices
  int nValid{0};
};

static bool neighborClass(const std::string &cur, const std::string &cls) {
  return (cur == "Car" && cls == "Van") ||
         (cur == "Pedestrian" && cls == "Person_sitting");
}

static Cleaned clean(const std::vector<Obj> &gt, const std::vector<Obj> &det,
                     const std::string &cur, int diff) {
  Cleaned c;
  for (size_t i = 0; i < gt.size(); i++) {
    const Obj &g = gt[i];
    bool hard = g.occ > MAX_OCCLUSION[diff] || g.trunc > MAX_TRUNCATION[diff] ||
                (g.y2 - g.y1) < MIN_HEIGHT[diff];
    if (g.cls == cur) {
      if (hard) {
        c.iGt.push_back(1);
      } else {
        c.iGt.push_back(0);
        c.nValid++;
      }
    } else if (neighborClass(cur, g.cls)) {
      c.iGt.push_back(1);
    } else if (g.cls == "DontCare") {
      c.iGt.push_back(-1);
      c.dontcare.push_back((int)i);
    } else {
      c.iGt.push_back(-1);
    }
  }
  for (const Obj &d : det) {
    if (d.cls != cur)
      c.iDet.push_back(-1);
    else if ((d.y2 - d.y1) < MIN_HEIGHT[diff])
      c.iDet.push_back(1);
    else
      c.iDet.push_back(0);
  }
  return c;
}

// first pass: collect TP scores at the IoU threshold
static void tpScores(const std::vector<Obj> &gt, const std::vector<Obj> &det,
                     const Cleaned &c, Metric m, double thr,
                     std::vector<double> &scores) {
  std::vector<bool> assigned(det.size(), false);
  for (size_t gi = 0; gi < gt.size(); gi++) {
    if (c.iGt[gi] != 0) continue;
    int best = -1;
    for (size_t di = 0; di < det.size(); di++) {
      if (c.iDet[di] == -1 || assigned[di]) continue;
      double ov = overlap(m, det[di], gt[gi]);
      // devkit !compute_fp pass: max score among overlap > thr
      if (ov > thr && (best < 0 || det[di].score > det[best].score)) best = (int)di;
    }
    if (best >= 0) {
      assigned[best] = true;
      scores.push_back(det[best].score);
    }
  }
}

struct Stat {
  double tp{0}, fp{0}, fn{0}, aos{0};
};

static Stat statsAt(const std::vector<Obj> &gt, const std::vector<Obj> &det,
                    const Cleaned &c, Metric m, double thr, double scoreT) {
  Stat s;
  std::vector<bool> assigned(det.size(), false);
  for (size_t gi = 0; gi < gt.size(); gi++) {
    if (c.iGt[gi] == -1) continue;
    int best = -1;
    bool bestIgnored = false;
    double maxOv = 0.0;
    for (size_t di = 0; di < det.size(); di++) {
      if (c.iDet[di] == -1 || assigned[di] || det[di].score < scoreT) continue;
      double ov = overlap(m, det[di], gt[gi]);
      if (ov <= thr) continue;
      // devkit compute_fp pass: prefer non-ignored dets by MAX OVERLAP
      // (not score); fall back to an ignored det only when none chosen.
      if (c.iDet[di] == 0 && (ov > maxOv || bestIgnored)) {
        best = (int)di;
        maxOv = ov;
        bestIgnored = false;
      } else if (c.iDet[di] == 1 && best < 0) {
        best = (int)di;
        bestIgnored = true;
      }
    }
    if (best < 0 && c.iGt[gi] == 0) {
      s.fn += 1;
    } else if (best >= 0 && (c.iGt[gi] == 1 || bestIgnored)) {
      assigned[best] = true;
    } else if (best >= 0) {
      s.tp += 1;
      s.aos += (1.0 + std::cos(gt[gi].alpha - det[best].alpha)) / 2.0;
      assigned[best] = true;
    }
  }
  for (size_t di = 0; di < det.size(); di++) {
    if (assigned[di] || c.iDet[di] != 0 || det[di].score < scoreT) continue;
    bool inDc = false;
    for (int gi : c.dontcare) {
      const Obj &dc = gt[gi];
      const Obj &d = det[di];
      double ix = std::min(d.x2, dc.x2) - std::max(d.x1, dc.x1);
      double iy = std::min(d.y2, dc.y2) - std::max(d.y1, dc.y1);
      double inter = std::max(ix, 0.0) * std::max(iy, 0.0);
      if (inter / std::max((d.x2 - d.x1) * (d.y2 - d.y1), 1e-12) > thr) {
        inDc = true;
        break;
      }
    }
    if (!inDc) s.fp += 1;
  }
  return s;
}

static std::vector<double> thresholds(std::vector<double> scores, int nGt) {
  std::sort(scores.begin(), scores.end(), std::greater<double>());
  std::vector<double> out;
  double currentRecall = 0;
  for (size_t i = 0; i < scores.size(); i++) {
    double lRecall = (double)(i + 1) / nGt;
    double rRecall = i < scores.size() - 1 ? (double)(i + 2) / nGt : lRecall;
    if ((rRecall - currentRecall) < (currentRecall - lRecall) &&
        i < scores.size() - 1)
      continue;
    out.push_back(scores[i]);
    currentRecall += 1.0 / (N_SAMPLE_PTS - 1.0);
  }
  return out;
}

int main(int argc, char **argv) {
  if (argc < 6) {
    std::fprintf(stderr,
                 "usage: kitti_ap <gt_dir> <pred_dir> <out_dir> <class> <thr>\n");
    return 1;
  }
  std::string gtDir = argv[1], predDir = argv[2], outDir = argv[3],
              cls = argv[4];
  double thr = std::atof(argv[5]);
  mkdir(outDir.c_str(), 0755);

  // image ids = prediction files present
  std::vector<std::string> ids;
  if (DIR *dp = opendir(predDir.c_str())) {
    while (dirent *e = readdir(dp)) {
      std::string n = e->d_name;
      if (n.size() > 4 && n.substr(n.size() - 4) == ".txt")
        ids.push_back(n.substr(0, n.size() - 4));
    }
    closedir(dp);
  }
  std::sort(ids.begin(), ids.end());

  std::vector<std::vector<Obj>> gts, dets;
  for (const auto &id : ids) {
    gts.push_back(parseFile(gtDir + "/" + id + ".txt"));
    dets.push_back(parseFile(predDir + "/" + id + ".txt"));
  }

  const char *suffix[3] = {"detection", "detection_ground", "detection_3d"};
  std::string lower = cls;
  for (auto &ch : lower) ch = std::tolower(ch);

  for (int m = 0; m < 3; m++) {
    double prec[3][N_SAMPLE_PTS] = {{0}};
    double aosv[3][N_SAMPLE_PTS] = {{0}};
    for (int diff = 0; diff < 3; diff++) {
      std::vector<Cleaned> cleaned;
      int nGt = 0;
      for (size_t i = 0; i < ids.size(); i++) {
        cleaned.push_back(clean(gts[i], dets[i], cls, diff));
        nGt += cleaned.back().nValid;
      }
      if (nGt == 0) continue;
      std::vector<double> scores;
      for (size_t i = 0; i < ids.size(); i++)
        tpScores(gts[i], dets[i], cleaned[i], (Metric)m, thr, scores);
      if (scores.empty()) continue;
      auto ths = thresholds(scores, nGt);
      std::vector<Stat> acc(ths.size());
      for (size_t i = 0; i < ids.size(); i++) {
        for (size_t t = 0; t < ths.size(); t++) {
          Stat s = statsAt(gts[i], dets[i], cleaned[i], (Metric)m, thr, ths[t]);
          acc[t].tp += s.tp;
          acc[t].fp += s.fp;
          acc[t].fn += s.fn;
          acc[t].aos += s.aos;
        }
      }
      for (size_t t = 0; t < ths.size(); t++) {
        double denom = std::max(acc[t].tp + acc[t].fp, 1e-12);
        prec[diff][t] = acc[t].tp / denom;
        aosv[diff][t] = acc[t].aos / denom;
      }
      // monotone decreasing from the right
      for (int t = 0; t < N_SAMPLE_PTS; t++) {
        double mx = 0, mxa = 0;
        for (int u = t; u < (int)ths.size(); u++) {
          mx = std::max(mx, prec[diff][u]);
          mxa = std::max(mxa, aosv[diff][u]);
        }
        prec[diff][t] = t < (int)ths.size() ? mx : 0.0;
        aosv[diff][t] = t < (int)ths.size() ? mxa : 0.0;
      }
    }
    {
      std::ofstream f(outDir + "/stats_" + lower + "_" + suffix[m] + ".txt");
      for (int d = 0; d < 3; d++) {
        for (int t = 0; t < N_SAMPLE_PTS; t++)
          f << prec[d][t] << (t + 1 < N_SAMPLE_PTS ? " " : "\n");
      }
    }
    if (m == IMAGE) {
      std::ofstream f(outDir + "/stats_" + lower + "_orientation.txt");
      for (int d = 0; d < 3; d++) {
        for (int t = 0; t < N_SAMPLE_PTS; t++)
          f << aosv[d][t] << (t + 1 < N_SAMPLE_PTS ? " " : "\n");
      }
    }
  }
  return 0;
}
