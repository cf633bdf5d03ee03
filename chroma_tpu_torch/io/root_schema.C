// ROOT on-disk schema for chroma events.
//
// The class LAYOUT (names, member names, member types) matches the
// reference's chroma/io/root.C so files written by either framework are
// readable by the other and by existing ROOT analysis macros. The
// implementation (fill/read helpers below) is this framework's own:
// batched array transfer instead of the reference's per-field loops.

#include <TVector3.h>
#include <TTree.h>
#include <map>
#include <string>
#include <vector>

struct Vertex {
  virtual ~Vertex() {}

  std::string particle_name;
  TVector3 pos;
  TVector3 dir;
  TVector3 pol;
  double ke;
  double t0;
  int trackid;
  int pdgcode;

  std::vector<Vertex> children;
  std::vector<double> step_x, step_y, step_z, step_t, step_dx, step_dy,
      step_dz, step_ke, step_edep, step_qedep;

  ClassDef(Vertex, 1);
};

struct Photon {
  virtual ~Photon() {}

  double t;
  TVector3 pos;
  TVector3 dir;
  TVector3 pol;
  double wavelength;  // nm
  unsigned int flag;
  int last_hit_triangle;
  int channel;

  ClassDef(Photon, 1);
};

struct Channel {
  Channel() : id(-1), t(-1e9), q(-1e9) {}
  virtual ~Channel() {}

  int id;
  double t;
  double q;
  unsigned int flag;

  ClassDef(Channel, 1);
};

struct Event {
  virtual ~Event() {}

  int id;
  unsigned int nhit;
  unsigned int nchannels;

  double TotalQ() const {
    double sum = 0.0;
    for (unsigned int i = 0; i < channels.size(); i++) sum += channels[i].q;
    return sum;
  }

  std::vector<Vertex> vertices;
  std::vector<Photon> photons_beg;
  std::vector<Photon> photons_end;
  std::vector<std::vector<Photon>> photon_tracks;
  std::vector<int> photon_parent_trackids;
  std::map<int, std::vector<Photon>> hits;
  std::vector<Photon> flat_hits;
  std::vector<Channel> channels;

  ClassDef(Event, 1);
};

// ---- batched transfer helpers (this framework's own interface) ----

void chroma_store_photons(std::vector<Photon> &out, unsigned int n,
                          float *pos, float *dir, float *pol,
                          float *wavelength, float *t,
                          unsigned int *flags, int *last_hit_triangles,
                          int *channels) {
  out.resize(n);
  for (unsigned int i = 0; i < n; i++) {
    Photon &p = out[i];
    p.pos.SetXYZ(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]);
    p.dir.SetXYZ(dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]);
    p.pol.SetXYZ(pol[3 * i], pol[3 * i + 1], pol[3 * i + 2]);
    p.wavelength = wavelength[i];
    p.t = t[i];
    p.flag = flags[i];
    p.last_hit_triangle = last_hit_triangles[i];
    p.channel = channels ? channels[i] : -1;
  }
}

void chroma_load_photons(const std::vector<Photon> &in, float *pos,
                         float *dir, float *pol, float *wavelength,
                         float *t, unsigned int *flags,
                         int *last_hit_triangles, int *channels) {
  for (unsigned int i = 0; i < in.size(); i++) {
    const Photon &p = in[i];
    pos[3 * i] = p.pos.X(); pos[3 * i + 1] = p.pos.Y();
    pos[3 * i + 2] = p.pos.Z();
    dir[3 * i] = p.dir.X(); dir[3 * i + 1] = p.dir.Y();
    dir[3 * i + 2] = p.dir.Z();
    pol[3 * i] = p.pol.X(); pol[3 * i + 1] = p.pol.Y();
    pol[3 * i + 2] = p.pol.Z();
    wavelength[i] = p.wavelength;
    t[i] = p.t;
    flags[i] = p.flag;
    last_hit_triangles[i] = p.last_hit_triangle;
    if (channels) channels[i] = p.channel;
  }
}

void chroma_store_channels(std::vector<Channel> &out, unsigned int n,
                           int *hit, float *t, float *q,
                           unsigned int *flags) {
  out.resize(0);
  for (unsigned int i = 0; i < n; i++) {
    if (!hit[i]) continue;
    Channel c;
    c.id = i;
    c.t = t[i];
    c.q = q[i];
    c.flag = flags[i];
    out.push_back(c);
  }
}
